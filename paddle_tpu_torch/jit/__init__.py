"""Whole-train-step API (counterpart of ``paddle_tpu/jit``):
``TrainStep``."""
from .api import TrainStep

__all__ = ["TrainStep"]
