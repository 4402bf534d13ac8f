"""PyLayer: a user-defined VJP in Python (counterpart of
``paddle_tpu/autograd/py_layer.py``), run as a ``torch.autograd.Function``
underneath. ``forward(ctx, *args)`` and ``backward(ctx, *grads)`` see
surface tensors; ``ctx.save_for_backward`` honours the innermost
``saved_tensors_hooks`` (pack at save time, unpack at read time)."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor

_hooks_stack: list = []


class saved_tensors_hooks:
    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook

    def __enter__(self):
        _hooks_stack.append((self.pack_hook, self.unpack_hook))
        return self

    def __exit__(self, *exc):
        _hooks_stack.pop()
        return False


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self._unpack = None
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        if _hooks_stack:
            pack, unpack = _hooks_stack[-1]
            self._saved = tuple(pack(t) for t in tensors)
            self._unpack = unpack
        else:
            self._saved = tensors

    def saved_tensor(self):
        if self._unpack is not None:
            return tuple(self._unpack(p) for p in self._saved)
        return self._saved

    saved_tensors = saved_tensor

    def set_materialize_grads(self, value: bool):
        self.materialize_grads = bool(value)


def _wrap(x):
    return Tensor._from_data(x) if isinstance(x, torch.Tensor) else x


def _unwrap(x):
    return x._data if isinstance(x, Tensor) else x


class _Bridge(torch.autograd.Function):
    """Runs ``cls.forward`` on detached surface tensors, ``cls.backward``
    on wrapped cotangents. The first argument is a holder (cls, ctx,
    args, kwargs, single-output flag); the rest are the tensor inputs."""

    @staticmethod
    def forward(fctx, holder, *tensors):
        cls, ctx, args, kwargs = holder[:4]
        it = iter(tensors)
        call = [Tensor._from_data(next(it).detach())
                if isinstance(a, Tensor) else a for a in args]
        with torch.no_grad():
            outs = cls.forward(ctx, *call, **kwargs)
        single = not isinstance(outs, (tuple, list))
        holder.append(single)
        outs = [outs] if single else list(outs)
        fctx.pylayer = (cls, ctx)
        fctx.set_materialize_grads(ctx.materialize_grads)
        return tuple(_unwrap(o) for o in outs)

    @staticmethod
    def backward(fctx, *grads):
        cls, ctx = fctx.pylayer
        gin = cls.backward(ctx, *[_wrap(g) for g in grads])
        gin = [_unwrap(g) for g in (
            gin if isinstance(gin, (tuple, list)) else (gin,))]
        needs = fctx.needs_input_grad[1:]
        if len(gin) != len(needs):
            # one gradient per differentiable input, as the JAX tape
            # takes them: spread over the inputs that need one
            it = iter(gin)
            gin = [next(it, None) if n else None for n in needs]
        return (None,) + tuple(gin)


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        holder = [cls, ctx, args, kwargs]
        tensors = [a._data for a in args if isinstance(a, Tensor)]
        outs = _Bridge.apply(holder, *tensors)
        outs = [_wrap(o) for o in outs]
        return outs[0] if holder[4] else tuple(outs)


LegacyPyLayer = PyLayer


def once_differentiable(fn):
    return fn
