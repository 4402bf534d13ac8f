"""Quantized execution layers (counterpart of
``paddle_tpu/quantization/layers.py``): ``WeightOnlyLinear`` (:20) with
``from_linear`` (:49), and ``quantize_for_inference`` (:140), the serving
entry for quantized decode.

The port has two kinds of model, so a converted linear comes in two
kinds, both ``WeightOnlyLinear``s:

- ``WeightOnlyLinear`` itself, an eager-surface ``Layer``, replaces the
  surface ``nn.Linear`` (weight [in, out]);
- ``WeightOnlyLinearModule``, a ``torch.nn.Module``, replaces
  ``torch.nn.Linear`` (weight [out, in], transposed before
  ``weight_quantize``) in the model zoo (``text/models``), which the
  ``Engine`` and ``text.generate`` serve. It is registered as a virtual
  subclass, so ``isinstance(m, WeightOnlyLinear)`` holds for it too.

Both keep the JAX package's buffers, names and layouts: ``weight`` int8
[in, out] (int4 values in an int8 container), ``weight_scale`` [out] (or
[in / 16, out] for int4's group scales) in the source weight's dtype, and
``bias`` when the source had one. They are buffers: not trainable, kept
by ``state_dict``, so a JAX-converted model's state loads as it is
(``bridge.llama_state_from_numpy``). The forward is
``nn.quant.weight_only_linear``.

The JAX package's tensor-parallel branch (``_shard_buffers``, ``_tp_kind``,
:84-133, converting ``ColumnParallelLinear`` / ``RowParallelLinear`` with
their 'mp' sharding) is not carried: the port's TP layers exist
(``distributed.fleet``), and converting them comes with the Engine on mp
ranks (ROADMAP section 1, item 3, D5b).
"""
from __future__ import annotations

import abc

import torch

from ..core import place as place_mod
from ..core.tensor import Tensor
from ..nn.layer.layers import Layer
from .functional import weight_quantize


def _algo(weight_dtype):
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be 'int8' or 'int4', got "
                         f"{weight_dtype!r}")
    return "weight_only_int4" if weight_dtype == "int4" else \
        "weight_only_int8"


class WeightOnlyLinear(Layer, metaclass=abc.ABCMeta):
    """A surface Linear executing with int8 (or int4-in-int8) weights and
    their scales. Built from a float Linear by ``from_linear``."""

    def __init__(self, in_features, out_features, has_bias=True,
                 weight_dtype="int8"):
        super().__init__()
        _algo(weight_dtype)
        self._in_features = int(in_features)
        self._out_features = int(out_features)
        self.weight_dtype = weight_dtype
        dev = place_mod.current_device()
        self.register_buffer("weight", Tensor._from_data(torch.zeros(
            (in_features, out_features), dtype=torch.int8, device=dev)))
        self.register_buffer("weight_scale", Tensor._from_data(
            torch.ones((out_features,), device=dev)))
        if has_bias:
            self.register_buffer("bias", Tensor._from_data(
                torch.zeros((out_features,), device=dev)))
        else:
            self.bias = None

    @classmethod
    def from_linear(cls, linear, weight_dtype="int8"):
        """Quantize a float linear: a surface ``nn.Linear`` gives a
        ``WeightOnlyLinear``, a ``torch.nn.Linear`` a
        ``WeightOnlyLinearModule``."""
        if isinstance(linear, torch.nn.Linear):
            return WeightOnlyLinearModule.from_linear(linear, weight_dtype)
        w = linear.weight._data.detach()
        q, scale = weight_quantize(w, algo=_algo(weight_dtype))
        bias = getattr(linear, "bias", None)
        lyr = cls(*w.shape, has_bias=bias is not None,
                  weight_dtype=weight_dtype)
        lyr._buffers["weight"] = Tensor._from_data(q)
        lyr._buffers["weight_scale"] = Tensor._from_data(scale)
        if bias is not None:
            lyr._buffers["bias"] = Tensor._from_data(
                bias._data.detach().clone())
        return lyr

    def forward(self, x):
        from ..nn.quant import weight_only_linear
        return weight_only_linear(x, self.weight, self.bias,
                                  self.weight_scale,
                                  weight_dtype=self.weight_dtype)

    def extra_repr(self):
        return (f"in={self._in_features}, out={self._out_features}, "
                f"dtype={self.weight_dtype}")


class WeightOnlyLinearModule(torch.nn.Module):
    """``WeightOnlyLinear`` for ``torch.nn.Module`` trees: replaces a
    ``torch.nn.Linear``; the same buffers in the same layouts."""

    def __init__(self, in_features, out_features, has_bias=True,
                 weight_dtype="int8", device=None, dtype=torch.float32):
        super().__init__()
        _algo(weight_dtype)
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight_dtype = weight_dtype
        self.register_buffer("weight", torch.zeros(
            (in_features, out_features), dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            (out_features,), dtype=dtype, device=device))
        self.register_buffer("bias", torch.zeros(
            (out_features,), dtype=dtype, device=device)
            if has_bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: torch.nn.Linear, weight_dtype="int8"):
        w = linear.weight.detach()
        q, scale = weight_quantize(w.t(), algo=_algo(weight_dtype))
        m = cls(w.shape[1], w.shape[0], has_bias=linear.bias is not None,
                weight_dtype=weight_dtype, device="meta", dtype=w.dtype)
        m.weight, m.weight_scale = q, scale
        if linear.bias is not None:
            m.bias = linear.bias.detach().clone()
        return m

    def forward(self, x):
        from ..nn.quant import weight_only_linear
        return weight_only_linear(x, self.weight, self.bias,
                                  self.weight_scale,
                                  weight_dtype=self.weight_dtype)

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                f"dtype={self.weight_dtype}")


WeightOnlyLinear.register(WeightOnlyLinearModule)


def quantize_for_inference(model, weight_dtype="int8", targets=None):
    """Swap every linear of ``model`` for an executing
    ``WeightOnlyLinear`` (int8 or int4 weights on the device), IN PLACE;
    returns the model. A ``torch.nn.Module`` tree (the model zoo, what
    ``Engine`` and ``text.generate`` serve) has its ``torch.nn.Linear``s
    converted, a surface ``Layer`` tree its ``nn.Linear``s; ``targets``
    (layer classes) overrides that default."""
    if isinstance(model, torch.nn.Module):
        targets = targets or (torch.nn.Linear,)

        def walk_module(mod):
            for name, sub in list(mod.named_children()):
                if isinstance(sub, targets):
                    setattr(mod, name, WeightOnlyLinearModule.from_linear(
                        sub, weight_dtype))
                else:
                    walk_module(sub)

        walk_module(model)
        return model
    from ..nn.layer.common import Linear
    targets = targets or (Linear,)

    def walk(layer):
        for name, sub in list(layer._sub_layers.items()):
            if isinstance(sub, targets):
                layer._sub_layers[name] = WeightOnlyLinear.from_linear(
                    sub, weight_dtype)
            else:
                walk(sub)

    walk(model)
    return model
