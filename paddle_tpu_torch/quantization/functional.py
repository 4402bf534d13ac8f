"""Quantization ops (counterpart of ``paddle_tpu/quantization/functional.py``):
the fake-quant family (:14-47), ``quantize_linear`` /
``dequantize_linear`` (:59-75), the KV-cache quantizers (:78-99) and the
weight-only quantizers ``weight_quantize`` (:102) / ``weight_dequantize``
(:165).

Every op but the KV pair follows ``nn.functional``'s rule
(``core.dispatch.surface``): surface Tensors in, surface Tensors out;
raw torch tensors in, raw torch tensors out. ``weight_quantize`` computes
the absmax, the division and the rounding in the weight's own dtype, as
the JAX package does (a bf16 weight is not upcast, so ties round the
same way); ``torch.round`` rounds half to even like ``jnp.round``. Its
divisors are 0-dim tensors: CUDA divides by a Python scalar as a
multiply by the reciprocal, an ulp off the quotient the CPU (and the JAX
package) computes, so the card's scales would differ from the CPU's.
"""
from __future__ import annotations

import torch

from ..core.dispatch import surface

__all__ = ["fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
           "fake_channel_wise_quantize_dequantize_abs_max",
           "quantize_linear", "dequantize_linear", "kv_quantize_arrays",
           "kv_dequantize_arrays", "weight_quantize", "weight_dequantize"]

WEIGHT_ALGOS = ("weight_only_int8", "weight_only_int4", "llm.int8")


def _qmax(bit_length):
    return float(2 ** (bit_length - 1) - 1)


def fake_quantize_abs_max(x, bit_length=8, name=None):
    """(quantized levels as floats, the absmax scale)."""
    qmax = _qmax(bit_length)

    def fn(a):
        scale = a.abs().amax()
        return torch.round(a / torch.clamp(scale, min=1e-12) * qmax), scale
    return surface("fake_quantize_abs_max", fn, [x])


def fake_quantize_dequantize_abs_max(x, bit_length=8, name=None):
    """The quantize-dequantize round trip (the QAT forward): zero gradient
    through the rounding, the absmax scale's gradient kept."""
    qmax = _qmax(bit_length)

    def fn(a):
        scale = torch.clamp(a.abs().amax(), min=1e-12)
        return torch.round(a / scale * qmax) * scale / qmax
    return surface("fake_quantize_dequantize_abs_max", fn, [x])


def fake_channel_wise_quantize_dequantize_abs_max(x, bit_length=8,
                                                  quant_axis=0, name=None):
    qmax = _qmax(bit_length)

    def fn(a):
        axes = tuple(i for i in range(a.dim()) if i != quant_axis)
        scale = torch.clamp(a.abs().amax(dim=axes, keepdim=True), min=1e-12)
        return torch.round(a / scale * qmax) * scale / qmax
    return surface("fake_channel_wise_quantize_dequantize_abs_max", fn, [x])


def _axis_shape(a, s, quant_axis):
    """A per-channel scale reshaped to broadcast along ``quant_axis``."""
    if s.dim() == 0 or quant_axis is None:
        return s
    shape = [1] * a.dim()
    shape[quant_axis % a.dim()] = s.shape[0]
    return s.reshape(shape)


def quantize_linear(x, scale, zero_point=0.0, bit_length=8, quant_axis=-1,
                    name=None):
    qmax = _qmax(bit_length)

    def fn(a, s):
        s = _axis_shape(a, s, quant_axis)
        return torch.clamp(torch.round(a / s + zero_point), -qmax - 1, qmax)
    return surface("quantize_linear", fn, [x, scale])


def dequantize_linear(x, scale, zero_point=0.0, bit_length=8,
                      quant_axis=-1, name=None):
    def fn(a, s):
        return (a - zero_point) * _axis_shape(a, s, quant_axis)
    return surface("dequantize_linear", fn, [x, scale])


def kv_quantize_arrays(x: torch.Tensor, bound: float = 127.0):
    """Symmetric int8 quantization of a KV chunk along its LAST axis
    (head_dim): one scale per (token, kv_head), so a new token's absmax
    never rescales entries already written.

    x: [..., d] float -> (q int8 [..., d], scale f32 [...]).
    """
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / bound
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -bound, bound)
    return q.to(torch.int8), scale


def kv_dequantize_arrays(q: torch.Tensor, scale: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Inverse of kv_quantize_arrays: q int8 [..., d], scale [...] ->
    float [..., d], multiplied in f32."""
    return (q.float() * scale[..., None].float()).to(dtype)


def _div(a, v):
    """a / v, v a Python number, divided as the CPU divides on any
    device."""
    return a / torch.full((), v, dtype=a.dtype, device=a.device)


def _int4_groups(g, absmax):
    """The int4 grid's scale per group, of two candidates (absmax / 7 and
    the shrink absmax / 7.5 that spends the container's -8 level), picked
    per (group, column) by the squared error summed in the weight's dtype;
    the first candidate wins ties (JAX :138-156). g: [K/gs, gs, N]."""
    best_q = best_s = best_e = None
    for den in (7.0, 7.5):
        s = _div(absmax, den)
        q = torch.clamp(torch.round(g / torch.clamp(s[:, None, :],
                                                    min=1e-12)), -8.0, 7.0)
        e = ((q * s[:, None, :] - g) ** 2).sum(dim=1)
        if best_q is None:
            best_q, best_s, best_e = q, s, e
        else:
            m = e < best_e
            best_q = torch.where(m[:, None, :], q, best_q)
            best_s = torch.where(m, s, best_s)
            best_e = torch.minimum(e, best_e)
    return best_q, best_s


def _weight_quantize(a, algo, group_size):
    int4 = algo == "weight_only_int4"
    bound = 7.0 if int4 else 127.0
    gs = group_size
    if gs == -1 and int4 and a.shape[0] % 16 == 0:
        gs = 16
    if gs > 0:
        k, n = a.shape
        if k % gs:
            raise ValueError("group_size must divide K")
        g = a.reshape(k // gs, gs, n)
        absmax = g.abs().amax(dim=1)                       # [K/gs, N]
        if int4:
            q, scale = _int4_groups(g, absmax)
            return q.to(torch.int8).reshape(k, n), scale
        scale = _div(absmax, bound)
        q = torch.clamp(torch.round(g / torch.clamp(scale[:, None, :],
                                                    min=1e-12)),
                        -bound, bound)
        return q.to(torch.int8).reshape(k, n), scale
    scale = _div(a.abs().amax(dim=0), bound)
    q = torch.clamp(torch.round(a / torch.clamp(scale, min=1e-12)),
                    -bound, bound)
    return q.to(torch.int8), scale


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1,
                    name=None):
    """A weight [K, N] (paddle's [in, out] layout) -> (int8 values,
    scales in the weight's dtype): per column ([N]), or per group of
    ``group_size`` rows ([K/gs, N]). int4 values live in an int8
    container. With ``group_size=-1`` int4 groups rows by 16 whenever 16
    divides K (one whole-column scale is too coarse for 15 levels) and
    picks each group's scale of two candidates by quantization error;
    ``group_size=0`` forces per-column scales."""
    if algo not in WEIGHT_ALGOS:
        raise ValueError(f"unsupported weight_quantize algo {algo}")
    return surface("weight_quantize",
                   lambda a: _weight_quantize(a, algo, group_size), [x])


def _weight_dequantize(q, s):
    qf = q.float()
    if s.dim() == 2 and s.shape[0] != 1:
        gs = qf.shape[0] // s.shape[0]
        return (qf.reshape(s.shape[0], gs, -1)
                * s[:, None, :]).reshape(qf.shape)
    return qf * s


def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype=None,
                      name=None):
    """Inverse of weight_quantize: per-column and per-group scales, the
    product in f32 (``out_dtype`` is taken and ignored, as in the JAX
    package)."""
    return surface("weight_dequantize", _weight_dequantize, [x, scale])
