"""Calibration observers (counterpart of
``paddle_tpu/quantization/observers.py``): watch activations during PTQ
and produce quantization parameters."""
from __future__ import annotations

from ..core.dispatch import unwrap


class BaseObserver:
    """Observer contract (reference quantization/base_observer.py): the
    running min and max of what it saw."""

    def __init__(self, quant_bits=8):
        self.quant_bits = quant_bits
        self._min = None
        self._max = None

    def observe(self, tensor):
        a = unwrap(tensor).detach()
        lo, hi = float(a.min()), float(a.max())
        self._min = lo if self._min is None else min(self._min, lo)
        self._max = hi if self._max is None else max(self._max, hi)

    __call__ = observe

    def cal_thresholds(self):
        pass

    def scales(self):
        if self._max is None:
            return 1.0
        bound = 2 ** (self.quant_bits - 1) - 1
        return max(abs(self._min), abs(self._max)) / bound

    def zero_points(self):
        return 0


class AbsmaxObserver(BaseObserver):
    """Max-|x| calibration (reference observers/abs_max.py)."""
