"""In-place op variants, the trailing-underscore API (counterpart of
``paddle_tpu/ops/inplace.py``).

``make_inplace`` is the one rule every ``*_`` variant follows (those
generated here and the ones ``ops/__init__.py`` patches onto ``Tensor``):
the out-of-place result is cast back to the input's dtype, as the JAX
package writes into the existing typed buffer, and a cast result is
detached, as the JAX rebind cuts the gradient link. A tensor that takes
no part in a graph (no grad history, nothing requiring grad) is then
written in place, so an optimizer or a view holding its storage sees the
values; a tensor in a graph adopts the result and its graph instead
(torch would refuse an in-place write on a tensor autograd saved, where
JAX rebinds). ``cast_`` alone changes the dtype.

Each variant is exported at the package top level and patched onto
``Tensor`` (names patched there before keep their binding).
"""
from __future__ import annotations

import math as _pymath

import torch

from ..core import random as random_mod
from ..core.dispatch import unwrap
from . import creation, logic, manipulation, math


def make_inplace(opname, fn, cast_back=True):
    """The in-place variant ``opname`` of the out-of-place op ``fn``."""
    def inplace(x, *args, **kwargs):
        out = fn(x, *args, **kwargs)
        d, o, sg = x._data, out._data, out._sg
        if cast_back and o.dtype != d.dtype:
            o = o.detach().to(d.dtype)        # the cast cuts the graph
            if not sg and (o.is_floating_point() or o.is_complex()):
                o.requires_grad_(True)
            sg = not o.requires_grad
        if d.grad_fn is None and not (torch.is_grad_enabled() and (
                d.requires_grad or o.requires_grad)) and \
                d.shape == o.shape and d.dtype == o.dtype:
            with torch.no_grad():
                d.copy_(o)
        else:
            x._data, x._sg = o, sg
        return x
    inplace.__name__ = inplace.__qualname__ = opname
    inplace.__module__ = __name__
    inplace.__doc__ = f"In-place variant of {fn.__name__}."
    return inplace


# base op -> its module; every entry generates ``<name>_``
_BASES = {
    "abs": math, "acos": math, "acosh": math, "addmm": math, "asin": math,
    "asinh": math, "atan": math, "atanh": math, "copysign": math,
    "cos": math, "cosh": math, "cumprod": math, "cumsum": math,
    "digamma": math, "divide": math, "erf": math, "erfinv": math,
    "expm1": math, "floor_divide": math, "floor_mod": math, "frac": math,
    "gammainc": math, "gammaincc": math, "gammaln": math, "gcd": math,
    "hypot": math, "i0": math, "lcm": math, "ldexp": math, "lgamma": math,
    "log": math, "log10": math, "log1p": math, "log2": math, "logit": math,
    "mod": math, "multigammaln": math, "multiply": math,
    "nan_to_num": math, "neg": math, "polygamma": math, "renorm": math,
    "sin": math, "sinc": math, "sinh": math, "square": math, "tan": math,
    "tanh": math, "trunc": math, "remainder": math,
    "equal": logic, "greater_equal": logic, "greater_than": logic,
    "less": logic, "less_equal": logic, "less_than": logic,
    "not_equal": logic,
    "bitwise_and": logic, "bitwise_invert": logic,
    "bitwise_left_shift": logic, "bitwise_not": logic, "bitwise_or": logic,
    "bitwise_right_shift": logic, "bitwise_xor": logic,
    "logical_and": logic, "logical_not": logic, "logical_or": logic,
    "logical_xor": logic,
    "masked_scatter": manipulation, "t": manipulation,
    "transpose": manipulation,
    "tril": creation, "triu": creation,
}

_built = {base + "_": make_inplace(base + "_", getattr(mod, base))
          for base, mod in _BASES.items()}
globals().update(_built)

cast_ = make_inplace("cast_", manipulation.cast, cast_back=False)
cast_.__doc__ = "In-place cast; unlike the other variants it changes dtype."

__all__ = sorted(list(_built) + ["bernoulli_", "cauchy_", "geometric_",
                                 "log_normal_", "cast_"])


def _fill(x, vals):
    """Write random ``vals`` into x: in place on a leaf, else x becomes a
    fresh leaf holding them (the fill cuts any graph, as in JAX)."""
    vals = vals.to(x._data.dtype)
    if x._data.grad_fn is None:
        with torch.no_grad():
            x._data.copy_(vals)
    else:
        if not x._sg and vals.is_floating_point():
            vals.requires_grad_(True)
        x._data = vals
    return x


def _uniform(x, lo=0.0, hi=1.0):
    d = x._data
    return torch.empty(d.shape, dtype=torch.float32, device=d.device
                       ).uniform_(lo, hi,
                                  generator=random_mod.generator(d.device))


def bernoulli_(x, p=0.5, name=None):
    """Fill x with Bernoulli(p) draws (p is the probability, not x)."""
    pr = unwrap(p)
    if isinstance(pr, torch.Tensor):
        pr = pr.to(x._data.device, torch.float32)
    return _fill(x, _uniform(x) < pr)


def cauchy_(x, loc=0, scale=1, name=None):
    """Fill x with Cauchy(loc, scale) draws."""
    u = _uniform(x, 1e-7, 1.0 - 1e-7)
    return _fill(x, loc + scale * torch.tan(_pymath.pi * (u - 0.5)))


def geometric_(x, probs, name=None):
    """Fill x with Geometric(probs) draws (trials to the first success)."""
    u = _uniform(x, 1e-7, 1.0 - 1e-7)
    p = unwrap(probs)
    p = torch.as_tensor(p, dtype=torch.float32, device=u.device)
    return _fill(x, torch.ceil(torch.log1p(-u) / torch.log1p(-p)))


def log_normal_(x, mean=1.0, std=2.0, name=None):
    """Fill x with LogNormal(mean, std) draws."""
    d = x._data
    z = torch.empty(d.shape, dtype=torch.float32, device=d.device).normal_(
        generator=random_mod.generator(d.device))
    return _fill(x, torch.exp(mean + std * z))
