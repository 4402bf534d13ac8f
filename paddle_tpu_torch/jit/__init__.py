"""Whole-train-step API (counterpart of ``paddle_tpu/jit``):
``TrainStep`` and ``compile_train_step``."""
from .api import TrainStep, compile_train_step

__all__ = ["TrainStep", "compile_train_step"]
