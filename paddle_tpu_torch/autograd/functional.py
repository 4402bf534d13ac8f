"""Functional autograd: grad, vjp, jvp, Jacobian, Hessian (counterpart of
``paddle_tpu/autograd/functional.py``), over ``torch.autograd.grad`` and
``torch.autograd.functional``."""
from __future__ import annotations

import torch

from ..core.dispatch import unwrap, wrap
from ..core.tensor import Tensor


def _list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: d outputs / d inputs, leaving every ``.grad`` alone.
    As in the JAX package the graph is kept unless ``retain_graph`` is
    False, and an input the outputs do not reach gets zeros (None with
    ``allow_unused``)."""
    outputs, inputs = _list(outputs), _list(inputs)
    if grad_outputs is None:
        seeds = [torch.ones_like(o._data) for o in outputs]
    else:
        seeds = [torch.ones_like(o._data) if g is None else unwrap(g)
                 for o, g in zip(outputs, _list(grad_outputs))]
    gs = torch.autograd.grad(
        [o._data for o in outputs], [t._data for t in inputs], seeds,
        retain_graph=True if retain_graph is None else retain_graph,
        create_graph=create_graph, allow_unused=True)
    out = []
    for t, g in zip(inputs, gs):
        if g is None and not allow_unused:
            g = torch.zeros_like(t._data)
        out.append(None if g is None else wrap(g))
    return out


def _as_fn(func):
    """A torch-level function of ``func`` (a function of surface tensors)."""
    def fn(*arrs):
        out = func(*[Tensor._from_data(a) for a in arrs])
        if isinstance(out, (list, tuple)):
            return tuple(unwrap(o) for o in out)
        return unwrap(out)
    return fn


def _wrap_tree(t):
    if isinstance(t, (list, tuple)):
        return [_wrap_tree(x) for x in t]
    return wrap(t)


def _unwrap_v(v):
    if v is None:
        return None
    if isinstance(v, (list, tuple)):
        return tuple(unwrap(x) for x in v)
    return unwrap(v)


def vjp(func, xs, v=None):
    """(func(xs), v^T J); ``v`` defaults to ones, as in the JAX package."""
    arrays = tuple(unwrap(x).detach() for x in _list(xs))
    fn = _as_fn(func)
    if v is None:
        with torch.no_grad():
            out = fn(*arrays)
        v = tuple(map(torch.ones_like, out)) if isinstance(out, tuple) \
            else torch.ones_like(out)
    out, grads = torch.autograd.functional.vjp(fn, arrays, _unwrap_v(v))
    grads = grads[0] if len(grads) == 1 else list(grads)
    return _wrap_tree(out), _wrap_tree(grads)


def jvp(func, xs, v=None):
    arrays = tuple(unwrap(x).detach() for x in _list(xs))
    tangents = tuple(torch.ones_like(a) for a in arrays) if v is None \
        else tuple(unwrap(t) for t in _list(v))
    out, jv = torch.autograd.functional.jvp(_as_fn(func), arrays, tangents)
    return _wrap_tree(out), _wrap_tree(jv)


class _Lazy:
    def __init__(self, value, is_batched):
        self._value = value
        self.is_batched = is_batched

    def _first(self):
        return self._value if isinstance(self._value, Tensor) \
            else self._value[0]

    def __getitem__(self, idx):
        return self._first()[idx]

    @property
    def shape(self):
        return self._first().shape


class Jacobian(_Lazy):
    """Jacobian of ``func`` at ``xs`` (``torch.autograd.functional.jacobian``)."""

    def __init__(self, func, xs, is_batched=False):
        arrays = tuple(unwrap(x).detach() for x in _list(xs))
        jac = torch.autograd.functional.jacobian(_as_fn(func), arrays)
        jac = jac if isinstance(jac, tuple) else (jac,)
        super().__init__(wrap(jac[0]) if len(jac) == 1
                         else [wrap(j) for j in jac], is_batched)


class Hessian(_Lazy):
    def __init__(self, func, xs, is_batched=False):
        arrays = tuple(unwrap(x).detach() for x in _list(xs))
        hess = torch.autograd.functional.hessian(
            _as_fn(func), arrays[0] if len(arrays) == 1 else arrays)
        super().__init__(wrap(hess), is_batched)


def jacobian(func, xs, is_batched=False):
    return Jacobian(func, xs, is_batched)


def hessian(func, xs, is_batched=False):
    return Hessian(func, xs, is_batched)


def forward_grad(func, xs, v=None):
    return jvp(func, xs, v)[1]
