"""Activation functionals (counterpart of ``paddle_tpu/nn/functional/activation.py``).

Surface Tensors go through ``run_op``; raw torch tensors take the same
body and come out raw. ``gelu`` keeps ``jax.nn.gelu``'s arithmetic in
x's dtype (bit-equal to the JAX one in bf16). The in-place variants
(``relu_``, ...) rebind their surface input to the result.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core import random as random_mod
from ...core.dispatch import surface, unwrap


def _unary(op_name, fn):
    def op(x, name=None):
        return surface(op_name, fn, [x])
    op.__name__ = op_name
    return op


relu = _unary("relu", torch.relu)
relu6 = _unary("relu6", TF.relu6)
sigmoid = _unary("sigmoid", torch.sigmoid)
tanh = _unary("tanh", torch.tanh)
silu = _unary("silu", TF.silu)
swish = silu
mish = _unary("mish", lambda a: a * torch.tanh(TF.softplus(a)))
tanhshrink = _unary("tanhshrink", lambda a: a - torch.tanh(a))
softsign = _unary("softsign", lambda a: a / (1 + torch.abs(a)))
log_sigmoid = _unary("log_sigmoid", TF.logsigmoid)
hardswish = _unary("hardswish", TF.hardswish)


def _gelu(x, approximate):
    if approximate:
        c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype)
    return (0.5 * x) * torch.erfc((-x * sqrt_half).float()).to(x.dtype)


def gelu(x, approximate=False, name=None):
    """GELU as ``jax.nn.gelu`` computes it in x's dtype: exact, ``0.5 * x
    * erfc(-x * sqrt(0.5))`` with ``sqrt(0.5)`` in x's dtype and ``erfc``
    taken in f32 and rounded; ``approximate``, the tanh form."""
    return surface("gelu", _gelu, [x], approximate=approximate)


def leaky_relu(x, negative_slope=0.01, name=None):
    return surface("leaky_relu", lambda a: TF.leaky_relu(a, negative_slope),
                   [x])


def prelu(x, weight, data_format="NCHW", name=None):
    def fn(a, w):
        if w.numel() > 1:
            shape = [1] * a.dim()
            shape[1 if data_format[1] == "C" else a.dim() - 1] = w.numel()
            w = w.reshape(shape)
        return torch.where(a >= 0, a, w * a)
    return surface("prelu", fn, [x, weight])


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=True,
          name=None):
    if not training:
        return leaky_relu(x, (lower + upper) / 2.0)

    def fn(a):
        slope = torch.empty_like(a).uniform_(
            lower, upper, generator=random_mod.draw_generator(a.device))
        return torch.where(a >= 0, a, slope * a)
    return surface("rrelu", fn, [x])


def elu(x, alpha=1.0, name=None):
    return surface("elu", lambda a: TF.elu(a, alpha), [x])


def celu(x, alpha=1.0, name=None):
    return surface("celu", lambda a: TF.celu(a, alpha), [x])


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return surface("selu", lambda a: scale * torch.where(
        a > 0, a, alpha * torch.expm1(a)), [x])


def hardshrink(x, threshold=0.5, name=None):
    return surface("hardshrink", lambda a: torch.where(
        torch.abs(a) > threshold, a, torch.zeros_like(a)), [x])


def softshrink(x, threshold=0.5, name=None):
    return surface("softshrink", lambda a: torch.where(
        a > threshold, a - threshold, torch.where(
            a < -threshold, a + threshold, torch.zeros_like(a))), [x])


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return surface("hardsigmoid", lambda a: torch.clamp(
        slope * a + offset, 0.0, 1.0), [x])


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return surface("hardtanh", lambda a: torch.clamp(a, min, max), [x])


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return surface("softplus", lambda a: torch.where(
        beta * a > threshold, a, TF.softplus(beta * a) / beta), [x])


def maxout(x, groups, axis=1, name=None):
    def fn(a):
        ax = axis % a.dim()
        ch = a.shape[ax]
        shape = a.shape[:ax] + (ch // groups, groups) + a.shape[ax + 1:]
        return torch.amax(a.reshape(shape), dim=ax + 1)
    return surface("maxout", fn, [x])


def _cast_to(a, dtype):
    if dtype is None:
        return a
    from ...core import dtype as dtype_mod
    return a.to(dtype_mod.to_torch(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    return surface("softmax", lambda a: torch.softmax(_cast_to(a, dtype),
                                                      dim=axis), [x])


def log_softmax(x, axis=-1, dtype=None, name=None):
    return surface("log_softmax", lambda a: torch.log_softmax(
        _cast_to(a, dtype), dim=axis), [x])


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    def fn(a):
        u = torch.empty_like(a).uniform_(
            1e-10, 1.0, generator=random_mod.draw_generator(a.device))
        y = torch.softmax((a - torch.log(-torch.log(u))) / temperature,
                          dim=axis)
        if not hard:
            return y
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        return y_hard + (y - y.detach())
    return surface("gumbel_softmax", fn, [x])


def glu(x, axis=-1, name=None):
    def fn(a):
        a1, a2 = torch.chunk(a, 2, dim=axis)
        return a1 * torch.sigmoid(a2)
    return surface("glu", fn, [x])


def swiglu(x, y=None, name=None):
    if y is not None:
        return surface("swiglu", lambda a, b: TF.silu(a) * b, [x, y])

    def fn(a):
        a1, a2 = torch.chunk(a, 2, dim=-1)
        return TF.silu(a1) * a2
    return surface("swiglu", fn, [x])


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return surface("thresholded_relu", lambda a: torch.where(
        a > threshold, a, torch.full_like(a, value)), [x])


def _act_inplace(x, out):
    """``x`` adopts ``out``'s data (and graph), as the JAX one rebinds."""
    if unwrap(x) is x:
        return out
    x._data, x._sg = out._data, out._sg
    return x


def relu_(x, name=None):
    return _act_inplace(x, relu(x))


def elu_(x, alpha=1.0, name=None):
    return _act_inplace(x, elu(x, alpha))


def softmax_(x, axis=-1, dtype=None, name=None):
    return _act_inplace(x, softmax(x, axis, dtype))


def tanh_(x, name=None):
    return _act_inplace(x, tanh(x))


def hardtanh_(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return _act_inplace(x, hardtanh(x, min, max))


def leaky_relu_(x, negative_slope=0.01, name=None):
    return _act_inplace(x, leaky_relu(x, negative_slope))


def thresholded_relu_(x, threshold=1.0, value=0.0, name=None):
    return _act_inplace(x, thresholded_relu(x, threshold, value))
