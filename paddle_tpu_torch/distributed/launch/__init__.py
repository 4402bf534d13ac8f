"""``python -m paddle_tpu_torch.distributed.launch``: the launcher."""
from .main import build_parser, launch, main

__all__ = ["build_parser", "launch", "main"]
