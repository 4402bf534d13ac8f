from . import generation, models
from .generation import beam_search, generate

__all__ = ["beam_search", "generate", "generation", "models"]
