"""Op library assembly + Tensor method patching (counterpart of
``paddle_tpu/ops/__init__.py``).

Every functional op of math / manipulation / logic / search / stat is
also a ``Tensor`` method, Python operators are wired to ops (Python
scalars stay weakly typed), and ``x[idx]`` / ``x[idx] = v`` go through
``getitem`` / ``setitem``. An in-place variant (``add_``, ...) writes a
leaf that takes no part in a graph in place (an optimizer holding it
sees the write); otherwise the tensor adopts the result and its graph,
as the JAX package rebinds. ``setitem`` on a tensor in a graph is a new
graph node: the gradient reaches both the kept values and those
written; a negative-step slice reads and writes through ``torch.flip``
(torch slices take positive steps only). The ``*_`` variants all follow
``inplace.make_inplace``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import run_op, unwrap
from ..core.tensor import Tensor
from . import creation, linalg, logic, manipulation, math, search, stat
from . import inplace
from .inplace import make_inplace

_MODULES = [math, manipulation, logic, search, stat, linalg]

_METHOD_EXCLUDE = {
    "to_tensor", "builtins_sum", "builtins_abs", "builtins_min",
    "builtins_slice", "meshgrid", "broadcast_shape", "is_tensor", "wrap",
    "unwrap", "run_op", "run_op_nodiff",
}


def _patch_methods():
    protected = set(vars(Tensor))
    for mod in reversed(_MODULES):
        for name in dir(mod):
            if name.startswith("_") or name in _METHOD_EXCLUDE \
                    or name in protected:
                continue
            fn = getattr(mod, name)
            if not callable(fn) or isinstance(fn, type) or not getattr(
                    fn, "__module__", "").startswith("paddle_tpu_torch"):
                continue
            setattr(Tensor, name, fn)
    # paddle convention: Tensor.numel() is a 0-D int64 Tensor
    Tensor.numel = manipulation.numel
    Tensor.norm = linalg.norm
    for name, fn in dict(
            pow=math.pow_, add=math.add, subtract=math.subtract,
            multiply=math.multiply, divide=math.divide, mod=math.mod,
            floor_divide=math.floor_divide, matmul=math.matmul,
            dot=math.dot, cast=manipulation.cast, astype=manipulation.cast,
            reshape=manipulation.reshape, transpose=manipulation.transpose,
            sum=math.sum, mean=math.mean, max=math.max, min=math.min,
            prod=math.prod, all=logic.all, any=logic.any, abs=math.abs,
            clip=math.clip, sqrt=math.sqrt, exp=math.exp, log=math.log,
            tanh=math.tanh, sigmoid=math.sigmoid, argmax=search.argmax,
            argmin=search.argmin, argsort=search.argsort, sort=search.sort,
            topk=search.topk, unique=manipulation.unique,
            zeros_like=creation.zeros_like, ones_like=creation.ones_like,
            full_like=creation.full_like, bernoulli=creation.bernoulli,
            multinomial=creation.multinomial).items():
        setattr(Tensor, name, fn)


def _patch_inplace():
    pairs = {
        "add_": math.add, "subtract_": math.subtract,
        "multiply_": math.multiply, "divide_": math.divide,
        "scale_": math.scale, "clip_": math.clip, "exp_": math.exp,
        "sqrt_": math.sqrt, "rsqrt_": math.rsqrt, "floor_": math.floor,
        "ceil_": math.ceil, "round_": math.round, "abs_": math.abs,
        "tanh_": math.tanh, "sigmoid_": math.sigmoid, "neg_": math.neg,
        "reciprocal_": math.reciprocal, "pow_": math.pow_,
        "remainder_": math.remainder, "mod_": math.mod, "lerp_": math.lerp,
    }
    for name, fn in pairs.items():
        setattr(Tensor, name, make_inplace(name, fn))
    # every ops.inplace variant not bound above (cast_ among them)
    for name in inplace.__all__:
        if not hasattr(Tensor, name):
            setattr(Tensor, name, getattr(inplace, name))

    def uniform_(self, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
        return creation.uniform_inplace(self, min, max, seed)

    def normal_(self, mean=0.0, std=1.0, name=None):
        return creation.gaussian_inplace(self, mean, std)

    def exponential_(self, lam=1.0, name=None):
        return creation.exponential_(self, lam)

    Tensor.uniform_ = uniform_
    Tensor.normal_ = normal_
    Tensor.exponential_ = exponential_


def _scalar_op(op_name, body):
    """``o <op> s`` for a Python scalar ``o`` on the left, through the
    binary op's own body: the scalar is weakly typed as on the right
    (``math._scalar_like``: a float beside an integer tensor is float64,
    as in JAX) and bool operands are promoted."""
    def op(s, o):
        return run_op(op_name, lambda a: body(o, a), [s])
    return op


def _patch_operators():
    Tensor.__add__ = lambda s, o: math.add(s, o)
    Tensor.__radd__ = lambda s, o: math.add(s, o)
    Tensor.__sub__ = lambda s, o: math.subtract(s, o)
    Tensor.__rsub__ = lambda s, o: math.subtract(o, s) if isinstance(
        o, Tensor) else _scalar_op("rsub", math.subtract.body)(s, o)
    Tensor.__mul__ = lambda s, o: math.multiply(s, o)
    Tensor.__rmul__ = lambda s, o: math.multiply(s, o)
    Tensor.__truediv__ = lambda s, o: math.divide(s, o)
    Tensor.__rtruediv__ = lambda s, o: math.divide(o, s) if isinstance(
        o, Tensor) else _scalar_op("rdiv", math.divide.body)(s, o)
    Tensor.__floordiv__ = lambda s, o: math.floor_divide(s, o)
    Tensor.__mod__ = lambda s, o: math.remainder(s, o)
    Tensor.__pow__ = lambda s, o: math.pow_(s, o)
    Tensor.__rpow__ = _scalar_op("rpow", math.pow_.body)
    Tensor.__neg__ = lambda s: math.neg(s)
    Tensor.__abs__ = lambda s: math.abs(s)
    Tensor.__matmul__ = lambda s, o: math.matmul(s, o)
    Tensor.__rmatmul__ = lambda s, o: math.matmul(o, s)
    Tensor.__eq__ = lambda s, o: logic.equal(s, o)
    Tensor.__ne__ = lambda s, o: logic.not_equal(s, o)
    Tensor.__lt__ = lambda s, o: logic.less_than(s, o)
    Tensor.__le__ = lambda s, o: logic.less_equal(s, o)
    Tensor.__gt__ = lambda s, o: logic.greater_than(s, o)
    Tensor.__ge__ = lambda s, o: logic.greater_equal(s, o)
    Tensor.__and__ = lambda s, o: logic.bitwise_and(s, o)
    Tensor.__or__ = lambda s, o: logic.bitwise_or(s, o)
    Tensor.__xor__ = lambda s, o: logic.bitwise_xor(s, o)
    Tensor.__invert__ = lambda s: logic.bitwise_not(s)
    Tensor.__iadd__ = lambda s, o: s.add_(o)
    Tensor.__isub__ = lambda s, o: s.subtract_(o)
    Tensor.__imul__ = lambda s, o: s.multiply_(o)
    Tensor.__itruediv__ = lambda s, o: s.divide_(o)


def _index(idx, device):
    def conv(i):
        if isinstance(i, Tensor):
            return i._data
        if isinstance(i, (list, np.ndarray)):
            return torch.as_tensor(np.asarray(i), device=device)
        return i
    return tuple(conv(i) for i in idx) if isinstance(idx, tuple) \
        else conv(idx)


def _getitem(self, idx):
    tidx = _index(idx, self._data.device)
    return run_op("getitem", lambda a: manipulation._getitem_body(a, tidx),
                  [self])


def _setitem(self, idx, value):
    tidx = _index(idx, self._data.device)
    v = unwrap(value)
    in_graph = torch.is_grad_enabled() and (
        self._data.requires_grad or (isinstance(v, torch.Tensor)
                                     and v.requires_grad))
    if not in_graph:
        pidx, flips = manipulation._positive_steps(tidx, self._data.shape)
        with torch.no_grad():
            if flips:
                # a negative-step slice: write through a flipped copy
                b = self._data.flip(flips)
                b[pidx] = v
                self._data.copy_(b.flip(flips))
            else:
                self._data[tidx] = v
        return self
    out = run_op("setitem",
                 lambda a, vv: manipulation._setitem_body(a, tidx, vv),
                 [self, value])
    self._data, self._sg = out._data, out._sg
    return self


Tensor.__getitem__ = _getitem
Tensor.__setitem__ = _setitem

_patch_methods()
_patch_inplace()
_patch_operators()
