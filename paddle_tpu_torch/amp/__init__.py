"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``): eager
``auto_cast`` / ``decorate`` over the surface's ops (``auto_cast.py``),
the dynamic loss scaler and the numerical debugging tools
(``debugging.py``). The port's compiled-step path casts weights for the
forward in ``TrainStep(amp_dtype=...)`` instead."""
from .auto_cast import (BLACK_LIST, WHITE_LIST, amp_decorate, amp_guard,
                        amp_state, auto_cast, decorate)
from .grad_scaler import AmpScaler, GradScaler, OptimizerState
from . import debugging

__all__ = ["auto_cast", "amp_guard", "amp_state", "amp_decorate",
           "decorate", "WHITE_LIST", "BLACK_LIST", "GradScaler",
           "AmpScaler", "OptimizerState", "debugging", "is_bfloat16_supported",
           "is_float16_supported"]


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    return True
