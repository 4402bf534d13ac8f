"""The QAT / PTQ class surface (counterpart of
``paddle_tpu/quantization/qat.py``): ``QuantConfig``, ``QuantedWrapper``,
``QAT`` and ``PTQ``, whose ``convert`` emits ``WeightOnlyLinear``s that
execute with int8 (or int4) weights. Over the eager surface's Layers."""
from __future__ import annotations

import copy

import torch

from ..nn.layer.layers import Layer
from .functional import fake_quantize_dequantize_abs_max


class QuantConfig:
    """Which layer types get (activation, weight) quanters (reference
    quantization/config.py)."""

    def __init__(self, activation=None, weight=None, bit_length=8):
        self.activation = activation
        self.weight = weight
        self.bit_length = bit_length
        self._type_configs = {}

    def add_type_config(self, layer_type, activation=None, weight=None):
        for t in (layer_type if isinstance(layer_type, (list, tuple))
                  else [layer_type]):
            self._type_configs[t] = (activation, weight)

    def matches(self, layer) -> bool:
        return not self._type_configs or type(layer) in self._type_configs


class _StraightThrough(torch.autograd.Function):
    """The fake-quantized weight's value, the gradient passed to the float
    weight unchanged (what the JAX wrapper gets by running the inner layer
    on the weight Parameter holding the fake-quantized array)."""

    @staticmethod
    def forward(ctx, w, fq):
        return fq.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class QuantedWrapper(Layer):
    """Wraps a layer: fake-quantizes its input activations and (QAT) its
    weight on every forward. The input's fake quant has zero gradient
    through the rounding (its absmax scale's is kept); the weight's is
    straight-through."""

    def __init__(self, inner: Layer, bit_length=8, quant_weights=True):
        super().__init__()
        self.inner = inner
        self.bit_length = bit_length
        self.quant_weights = quant_weights

    def forward(self, x):
        x = fake_quantize_dequantize_abs_max(x, self.bit_length)
        w = getattr(self.inner, "weight", None)
        if not self.quant_weights or w is None:
            return self.inner(x)
        leaf = w._data
        fq = fake_quantize_dequantize_abs_max(leaf.detach(), self.bit_length)
        w._data = _StraightThrough.apply(leaf, fq)
        try:
            return self.inner(x)
        finally:
            w._data = leaf


def _wrap_model(model: Layer, config: QuantConfig, quant_weights):
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import Conv2D
    for name, sub in list(model._sub_layers.items()):
        if isinstance(sub, (Linear, Conv2D)) and config.matches(sub):
            model._sub_layers[name] = QuantedWrapper(sub, config.bit_length,
                                                     quant_weights)
        else:
            _wrap_model(sub, config, quant_weights)
    return model


def _maybe_copy(model: Layer, inplace: bool) -> Layer:
    """``inplace=False`` (the default) leaves the caller's model untouched
    and works on a deep copy."""
    return model if inplace else copy.deepcopy(model)


class QAT:
    """Quant-aware training (reference quantization/qat.py)."""

    def __init__(self, config: QuantConfig):
        self.config = config

    def quantize(self, model: Layer, inplace=False):
        return _wrap_model(_maybe_copy(model, inplace), self.config,
                           quant_weights=True)


class PTQ:
    """Post-training quantization (reference quantization/ptq.py):
    ``quantize`` inserts calibration-time fake-quant wrappers; ``convert``
    turns each wrapped Linear into a ``WeightOnlyLinear`` holding int8
    weights and per-channel scales (int4 at ``bit_length=4``) and
    unwraps the other layers back to float."""

    def __init__(self, config: QuantConfig):
        self.config = config

    def quantize(self, model: Layer, inplace=False):
        return _wrap_model(_maybe_copy(model, inplace), self.config,
                           quant_weights=False)

    def convert(self, model: Layer, inplace=False):
        from ..nn.layer.common import Linear
        from .layers import WeightOnlyLinear
        model = _maybe_copy(model, inplace)
        weight_dtype = "int4" if self.config.bit_length == 4 else "int8"

        def walk(layer):
            for name, sub in list(layer._sub_layers.items()):
                if isinstance(sub, QuantedWrapper):
                    layer._sub_layers[name] = (
                        WeightOnlyLinear.from_linear(sub.inner, weight_dtype)
                        if isinstance(sub.inner, Linear) else sub.inner)
                else:
                    walk(sub)

        walk(model)
        return model
