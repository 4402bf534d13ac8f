"""Eager op dispatch (counterpart of ``paddle_tpu/core/dispatch.py``).

Every surface op runs the JAX package's stages in its order
(:162-243): (1) the AMP cast of the inputs, by op name
(``amp/auto_cast.py``); (2) unwrap ``Tensor`` -> ``torch.Tensor``; (3)
the op's torch body; (4) ``FLAGS_check_nan_inf``, batched; (5) wrap.
Op names are the JAX package's, so the AMP lists hit the same ops.
There is no tape to record: the body's torch ops build torch's autograd
graph, so an output is differentiable exactly when some input is and
the output is floating.

Two hook lists let the profiler and ``amp.debugging`` watch every op
(:110-160 of the JAX module): ``OP_OBSERVERS`` see each op's output
tensors, ``OP_TIMING_HOOKS`` its host dispatch seconds and input
signature. Empty lists cost one truthiness test each per op.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from torch.compiler import is_compiling as _tracing

from .flags import get_flag
from .tensor import Tensor

#: ops dispatched through ``run_op`` / ``run_op_nodiff`` since import
#: (read by the per-op host-overhead measurement); ops traced by
#: ``jit.to_static`` are not dispatched at each call and count nothing
#: (a count bumped under the trace would also guard the compiled entry
#: on its value and recompile it at every call)
op_count = 0


def unwrap(x):
    """Tensor -> torch tensor; anything else passes."""
    return x._data if isinstance(x, Tensor) else x


def wrap(t, name=None):
    return Tensor._from_data(t, name=name)


def _wrap_tree(out, detach=False):
    if isinstance(out, torch.Tensor):
        return Tensor._from_data(out.detach() if detach else out)
    if isinstance(out, tuple):
        return tuple(_wrap_tree(o, detach) for o in out)
    if isinstance(out, list):
        return [_wrap_tree(o, detach) for o in out]
    return out


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return []


def _unwrap_all(tensor_args):
    """Unwrap the inputs; numpy arrays become tensors on the device of the
    first tensor input."""
    arrays = [unwrap(x) for x in tensor_args]
    if any(isinstance(a, np.ndarray) for a in arrays):
        dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
                   None)
        arrays = [torch.as_tensor(a, device=dev)
                  if isinstance(a, np.ndarray) else a for a in arrays]
    return arrays


# pending (op name, device-side bad flag) pairs, flushed in one host sync
# every FLAGS_check_nan_inf_batch ops (1: raise at the offending op)
_nan_pending = []


def _nan_report(name):
    msg = f"Op {name} output contains NaN/Inf"
    if get_flag("check_nan_inf_level") == 0:
        raise FloatingPointError(msg)
    print("WARNING:", msg)


def flush_nan_checks():
    """Sync and report every queued NaN/Inf flag (one device round-trip
    for the batch); call at a step boundary when batching."""
    global _nan_pending
    pending, _nan_pending = _nan_pending, []
    if not pending:
        return
    vals = torch.stack([b.to(pending[0][1].device)
                        for _, b in pending]).cpu().tolist()
    for (name, _), v in zip(pending, vals):
        if v:
            _nan_report(name)


def _check_nan_inf(name, out):
    flags = [~torch.isfinite(a.detach()).all() for a in _leaves(out)
             if a.is_floating_point() or a.is_complex()]
    if not flags:
        return
    bad = flags[0]
    for f in flags[1:]:
        bad = bad | f.to(bad.device)
    _nan_pending.append((name, bad))
    if len(_nan_pending) >= max(int(get_flag("check_nan_inf_batch") or 1),
                                1):
        flush_nan_checks()


#: observers called as ``obs(op_name, output_tensors)`` after every op
#: (``amp.debugging``'s operator stats and tensor dumps, the profiler's
#: output dtypes)
OP_OBSERVERS = []

#: hooks called as ``hook(op_name, seconds, input_signature)`` after every
#: op (``profiler.stats.OpDispatchTracer``). The seconds are host dispatch
#: time: on ``cuda`` the launch cost, since kernels run asynchronously.
OP_TIMING_HOOKS = []


def dtype_name(dtype) -> str:
    """A torch dtype under the JAX package's name (``float32``, ``bool``)."""
    return str(dtype).rpartition(".")[2]


def _notify(name, out):
    if OP_OBSERVERS:
        leaves = _leaves(out)
        for obs in list(OP_OBSERVERS):
            obs(name, leaves)


def input_signature(tensor_args) -> tuple:
    """``("(2, 3):float32", ...)`` of the tensor inputs: the key an eager
    op's shape churn is read by."""
    sig = []
    for x in tensor_args:
        a = unwrap(x)
        if isinstance(a, (torch.Tensor, np.ndarray)):
            sig.append(f"{tuple(a.shape)}:{dtype_name(a.dtype)}")
    return tuple(sig)


def _timed(runner, name, fn, tensor_args, attrs):
    t0 = time.perf_counter()
    try:
        return runner(name, fn, tensor_args, **attrs)
    finally:
        dt = time.perf_counter() - t0
        sig = input_signature(tensor_args)
        for hook in list(OP_TIMING_HOOKS):
            hook(name, dt, sig)


def run_op(name: str, fn: Callable, tensor_args: Sequence[Any], **attrs):
    """Run the differentiable op ``fn(*torch_inputs, **attrs)`` eagerly:
    AMP cast, unwrap, body, NaN check, wrap (a tensor, or a tuple/list
    of them, mirroring ``fn``'s output)."""
    if OP_TIMING_HOOKS:
        return _timed(_run_op, name, fn, tensor_args, attrs)
    return _run_op(name, fn, tensor_args, **attrs)


def _run_op(name: str, fn: Callable, tensor_args: Sequence[Any], **attrs):
    global op_count
    if not _tracing():
        op_count += 1
    if _amp_state.enabled:
        tensor_args = autocast_inputs(name, tensor_args)
    out = fn(*_unwrap_all(tensor_args), **attrs)
    if get_flag("check_nan_inf"):
        _check_nan_inf(name, out)
    _notify(name, out)
    return _wrap_tree(out)


def run_op_nodiff(name: str, fn: Callable, tensor_args: Sequence[Any],
                  **attrs):
    """Run a non-differentiable op (comparisons, argmax, ...): no AMP
    cast, the body under ``torch.no_grad()``, outputs stop gradients."""
    if OP_TIMING_HOOKS:
        return _timed(_run_op_nodiff, name, fn, tensor_args, attrs)
    return _run_op_nodiff(name, fn, tensor_args, **attrs)


def _run_op_nodiff(name: str, fn: Callable, tensor_args: Sequence[Any],
                   **attrs):
    global op_count
    if not _tracing():
        op_count += 1
    with torch.no_grad():
        out = fn(*_unwrap_all(tensor_args), **attrs)
    if get_flag("check_nan_inf"):
        _check_nan_inf(name, out)
    _notify(name, out)
    # detached: a view made under no_grad can still require grad
    return _wrap_tree(out, detach=True)


def defop(name: str, fn: Callable, differentiable=True):
    """A Tensor-level op made from a torch function."""
    runner = run_op if differentiable else run_op_nodiff

    def op(*args, name_=name, **kwargs):
        return runner(name_, fn, args, **kwargs)

    op.__name__ = name
    return op


def surface(name: str, body: Callable, args: Sequence[Any], **attrs):
    """``nn.functional``'s rule: a ``Tensor`` among ``args`` runs the op
    through ``run_op``; raw torch tensors go straight to ``body`` and come
    out raw (no AMP cast, no NaN check, no wrap)."""
    if any(isinstance(a, Tensor) for a in args):
        return run_op(name, body, args, **attrs)
    return body(*args, **attrs)


# at the bottom: ``amp`` imports this module. Bound at import, not on the
# first op, so that an op traced by ``jit.to_static`` imports nothing
from ..amp.auto_cast import _amp_state, autocast_inputs  # noqa: E402
