"""Device resolution for the port's entry points.

Counterpart of ``paddle_tpu/core/place.py``. The port serves on an
NVIDIA GPU: every entry point (``LlamaForCausalLM``, ``Engine``) runs on
``cuda`` unless the caller asks for the CPU, and raises when it was not
asked for the CPU and no GPU is present. It never moves to the CPU on
its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> the CPU; ``"cuda[:n]"`` -> that
    GPU. A CUDA device without a visible GPU raises RuntimeError naming
    the ``device="cpu"`` opt-in."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(
            f"unsupported device {dev!s}: the port runs on 'cuda' "
            f"(default) or, on request, 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port runs on an NVIDIA GPU "
            "by default; pass device='cpu' to run the plain PyTorch "
            "versions of its kernels on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
