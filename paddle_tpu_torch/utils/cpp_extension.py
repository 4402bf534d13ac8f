"""Custom-op extension API (counterpart of
``paddle_tpu/utils/cpp_extension.py``).

``load`` compiles C/C++ sources with ``g++`` into a shared library and
returns it as a ``ctypes.CDLL`` (symbols use the C ABI, ``extern "C"``);
``register_op`` lifts a forward, and an optional backward, into a
surface op: a ``torch.autograd.Function`` run through ``run_op``, where
the JAX package builds a ``jax.custom_vjp``. The op trains through
torch autograd, is importable as ``paddle_tpu_torch.ops.custom.<name>``
and, with ``tensor_method=True``, is a Tensor method.

    lib = load(name="my_ops", sources=["my_ops.cc"])   # g++ -shared

    def fwd(x):                       # host code: CPU tensors
        y = torch.empty_like(x)
        lib.scale2(ctypes.c_void_p(x.data_ptr()),
                   ctypes.c_void_p(y.data_ptr()), x.numel())
        return y

    def bwd(x, g):
        return (g * 2,)

    scale2 = register_op("scale2", fwd, backward=bwd)
"""
from __future__ import annotations

import os
import subprocess
from typing import Callable, Optional, Sequence

import torch


def _default_build_dir(name: str) -> str:
    from ..sysconfig import get_lib
    return os.path.join(get_lib(), "cpp_extension", name)


def load(name: str, sources: Sequence[str], extra_cflags=None,
         extra_ldflags=None, build_directory: Optional[str] = None,
         verbose: bool = False):
    """Compile ``sources`` with ``g++ -O2 -shared -fPIC`` into
    ``lib<name>.so`` (under ``build_directory``, default
    ``build/cpp_extension/<name>`` of the repository) and load it with
    ``ctypes``. Raises RuntimeError with the compiler's output when the
    build fails."""
    import ctypes

    build_dir = build_directory or _default_build_dir(name)
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, f"lib{name}.so")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", out,
           *map(str, sources), *(extra_cflags or []),
           *(extra_ldflags or [])]
    if verbose:
        print("cpp_extension:", " ".join(cmd))
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"cpp_extension build failed:\n{res.stderr}")
    return ctypes.CDLL(out)


_REGISTRY = {}


def register_op(name: str, forward: Callable, backward: Callable = None,
                tensor_method: bool = False):
    """Register a custom operator.

    ``forward(*tensors, **attrs)`` -> tensor(s): torch code, or a call
    into a ``load``-ed library. ``backward(*inputs, grad_out, **attrs)``
    -> a gradient (or a tuple of them) for each input, optional; with it
    the op trains through torch autograd (``grad_out`` is a tuple when
    the forward returns several tensors).

    Returns the Tensor-level op; it is also
    ``paddle_tpu_torch.ops.custom.<name>`` and (``tensor_method=True``) a
    Tensor method.
    """
    from ..core.dispatch import run_op
    from ..core.tensor import Tensor

    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, attrs, *xs):
            ctx.attrs = attrs
            ctx.save_for_backward(*xs)
            return forward(*xs, **attrs)

        @staticmethod
        def backward(ctx, *gs):
            g = gs[0] if len(gs) == 1 else gs
            grads = backward(*ctx.saved_tensors, g, **ctx.attrs)
            if not isinstance(grads, (list, tuple)):
                grads = (grads,)
            return (None, *grads)

    def op(*tensors, **attrs):
        if backward is None:
            return run_op(name, lambda *xs: forward(*xs, **attrs),
                          list(tensors))
        return run_op(name, lambda *xs: _Op.apply(attrs, *xs),
                      list(tensors))

    op.__name__ = name
    _REGISTRY[name] = op

    from .. import ops as ops_pkg
    custom = getattr(ops_pkg, "custom", None)
    if custom is None:
        import sys
        import types
        custom = types.ModuleType("paddle_tpu_torch.ops.custom")
        custom.__doc__ = "user-registered custom ops (cpp_extension)"
        ops_pkg.custom = custom
        # make `from paddle_tpu_torch.ops.custom import <op>` importable
        sys.modules["paddle_tpu_torch.ops.custom"] = custom
    setattr(custom, name, op)
    if tensor_method:
        setattr(Tensor, name, op)
    return op


def get_op(name: str):
    return _REGISTRY[name]
