"""paddle.nn.quant (counterpart of ``paddle_tpu/nn/quant/__init__.py``):
the quantized linears ``weight_only_linear`` (:23) and
``llm_int8_linear`` (:66), ``Stub``, the weight quantizers of
``quantization.functional`` and the QAT layer names (``quant_layers``).

Both linears are plain PyTorch, as the JAX ones are plain ``jnp``
products outside any Pallas kernel: ``torch.matmul`` for the float
products; the int8 x int8 -> int32 product of ``llm_int8_linear`` is
``torch._int_mm`` on a CUDA tensor and an int32 ``torch.matmul`` on a
CPU tensor, both exact, so the two devices agree bit for bit when no
outlier column takes the float path. Surface Tensors in, surface Tensors
out; raw torch tensors in, raw out (``core.dispatch.surface``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import surface
from ...quantization.functional import (  # noqa: F401
    _div, weight_dequantize, weight_quantize)
from . import quant_layers  # noqa: F401

__all__ = ["Stub", "weight_only_linear", "llm_int8_linear",
           "weight_quantize", "weight_dequantize", "quant_layers"]


class Stub:
    """A quant insertion point (reference nn/quant/stub.py): QAT replaces
    it with the configured quanter; eagerly it is the identity."""

    def __init__(self, observer=None):
        self._observer = observer

    def __call__(self, x):
        return x

    forward = __call__


def _weight_only(a, q, s, bias, group_size):
    if s.dim() == 2 and s.shape[0] != 1:
        # per-group scales vary along K: dequantize first
        w = (q.to(a.dtype).reshape(s.shape[0], q.shape[0] // s.shape[0], -1)
             * s[:, None, :].to(a.dtype)).reshape(q.shape)
        out = a @ w
    else:
        # per-column scales commute with the K contraction
        out = (a @ q.to(a.dtype)) * s.reshape(-1).to(a.dtype)
    return out if bias is None else out + bias


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1,
                       name=None):
    """x @ dequant(weight) + bias for an int8 (or int4-in-int8) weight
    [in, out] and its scales: per column ([out]) as ``(x @ q) * s``, per
    group of rows ([in / gs, out]) by dequantizing first. With no scale it
    is a plain linear on ``weight``."""
    if weight_scale is None:
        from ..functional import linear
        return linear(x, weight, bias)
    return surface("weight_only_linear",
                   lambda a, q, s, b: _weight_only(a, q, s, b, group_size),
                   [x, weight, weight_scale, bias])


def int8_matmul(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 [T, K] and int8 [K, N]: on CUDA
    ``torch._int_mm``, whose rows must be more than 16 and whose K and N
    multiples of 8 (zero rows, columns and K padding added and the result
    sliced back); on the CPU an int32 ``torch.matmul``."""
    if xq.device.type != "cuda":
        return xq.to(torch.int32) @ q.to(torch.int32)
    t, k = xq.shape
    n = q.shape[1]
    tp = max(32, -(-t // 8) * 8)
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    if (tp, kp) != (t, k):
        xq = TF.pad(xq, (0, kp - k, 0, tp - t))
    if (kp, np_) != (k, n):
        q = TF.pad(q, (0, np_ - n, 0, kp - k))
    return torch._int_mm(xq.contiguous(), q.contiguous())[:t, :n]


def _llm_int8(a, q, s, bias, threshold):
    af = a.float()
    flat = af.reshape(-1, af.shape[-1])                     # [T, K]
    col_scale = s.reshape(-1).float()                       # [N]
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    out_part = None
    if threshold and threshold > 0:
        outlier = (flat.abs() > threshold).any(dim=0)       # [K]
        inl = torch.where(outlier[None, :], zero, flat)
        out_part = torch.where(outlier[None, :], flat, zero)
    else:
        inl = flat
    # divided as on the CPU: CUDA divides by a Python scalar through its
    # reciprocal, an ulp off, and the card must equal the CPU bit for bit
    row_scale = _div(torch.clamp(inl.abs().amax(dim=-1, keepdim=True),
                                 min=1e-8), 127.0)
    xq = torch.clamp(torch.round(inl / row_scale), -127, 127).to(torch.int8)
    acc = int8_matmul(xq, q)                                # [T, N] int32
    out = acc.float() * row_scale * col_scale[None, :]
    if out_part is not None:
        out = out + out_part @ (q.float() * col_scale[None, :])
    out = out.reshape(*af.shape[:-1], q.shape[1]).to(a.dtype)
    return out if bias is None else out + bias


def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0,
                    name=None):
    """LLM.int8() linear: activations quantized per row to int8, an
    int32-accumulating product with the int8 weight [in, out], scaled by
    row x column scales; the feature columns where some |x| exceeds
    ``threshold`` are zeroed in the quantized operand and served by a
    masked float product instead (``threshold <= 0`` turns that off)."""
    if weight_scale is None:
        raise ValueError("llm_int8_linear requires weight_scale")
    return surface("llm_int8_linear",
                   lambda a, q, s, b: _llm_int8(a, q, s, b, threshold),
                   [x, weight, weight_scale, bias])
