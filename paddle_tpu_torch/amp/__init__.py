"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``): the
dynamic loss scaler. The port's training path casts weights for the
forward in ``TrainStep(amp_dtype=...)``; eager ``auto_cast`` and
``decorate`` are not carried yet."""
from .grad_scaler import AmpScaler, GradScaler, OptimizerState

__all__ = ["GradScaler", "AmpScaler", "OptimizerState",
           "is_bfloat16_supported", "is_float16_supported"]


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    return True
