"""Trainable quanters (counterpart of
``paddle_tpu/quantization/quanters.py``): the QAT fake-quant nodes."""
from __future__ import annotations

from ..nn.layer.layers import Layer
from .functional import fake_quantize_dequantize_abs_max


class BaseQuanter(Layer):
    """Quanter contract (reference quantization/base_quanter.py): the
    abs-max quantize-dequantize round trip of its input."""

    def __init__(self, quant_bits=8):
        super().__init__()
        self.quant_bits = quant_bits

    def forward(self, x):
        return fake_quantize_dequantize_abs_max(x,
                                                bit_length=self.quant_bits)

    def scales(self):
        return None

    def zero_points(self):
        return None


class FakeQuanterWithAbsMax(BaseQuanter):
    """Abs-max fake quant (reference quanters/abs_max.py)."""


_QUANTER_REGISTRY = {}


def quanter(name):
    """Class decorator registering a quanter under a config name
    (reference quantization/factory.py quanter)."""
    def wrap(cls):
        _QUANTER_REGISTRY[name] = cls
        return cls
    return wrap
