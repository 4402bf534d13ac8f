"""paddle.static.nn of the port (counterpart of ``paddle_tpu/static/nn.py``):
the static-graph layer builders map onto the dygraph functionals, and
the control flow keeps a ``jit.to_static`` graph whole.

- ``cond``: under a trace (``torch.compiler.is_compiling()``), the higher
  order op ``torch.cond`` (both branches traced, the taken one chosen at
  run time, each returning tensors of one structure, shapes and dtypes);
  eagerly, only the taken branch runs.
- ``while_loop``: under a trace, ``torch._higher_order_ops.while_loop``
  (a compiled loop whose carries keep their shapes and dtypes); eagerly,
  a Python loop. Whether the call is traced is read once, before the
  loop: ``cond`` is not called an extra time to probe it.
- ``case`` and ``switch_case`` run eagerly, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..core.dispatch import unwrap, wrap
from ..core.tensor import Tensor
from ..nn import functional as F

batch_norm = F.batch_norm
conv2d = F.conv2d
conv3d = F.conv3d


def _unwrap_tree(x):
    if isinstance(x, Tensor):
        return unwrap(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap_tree(a) for a in x)
    if isinstance(x, dict):
        return {k: _unwrap_tree(v) for k, v in x.items()}
    return x


def _wrap_tree(x):
    if isinstance(x, torch.Tensor):
        return wrap(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap_tree(a) for a in x)
    if isinstance(x, dict):
        return {k: _wrap_tree(v) for k, v in x.items()}
    return x


def _traced():
    return torch.compiler.is_compiling()


def _as_bool(p):
    """A predicate (Tensor, torch tensor, numpy or Python value) as a
    Python bool, for the eager branches."""
    p = unwrap(p)
    if isinstance(p, torch.Tensor):
        return bool(p.reshape(()).item())
    import numpy as np
    return bool(np.asarray(p).reshape(()))


def _branch(fn):
    """A branch of ``torch.cond``: ``fn``'s outputs as torch tensors (the
    missing branch returns None). Decided here, outside the branch: the
    tracer cannot branch on a function object inside one."""
    if fn is None:
        return lambda: None
    return lambda: _unwrap_tree(fn())


def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """Conditional (static.nn.cond, :38). Traced: ``torch.cond`` — the
    structured spelling that keeps a value-dependent branch compiled
    instead of breaking the graph. Eager: the taken branch only."""
    if _traced():
        p = unwrap(pred)
        if not isinstance(p, torch.Tensor):
            p = torch.as_tensor(p)
        return _wrap_tree(torch.cond(p.reshape(()).to(torch.bool),
                                     _branch(true_fn), _branch(false_fn),
                                     ()))
    if _as_bool(pred):
        return true_fn() if true_fn is not None else None
    return false_fn() if false_fn is not None else None


def case(pred_fn_pairs, default=None, name=None):
    """First-true-wins branch (static.nn.case, :64)."""
    for pred, fn in pred_fn_pairs:
        if _as_bool(pred):
            return fn()
    return default() if default is not None else None


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Branch by index (static.nn.switch_case, :75)."""
    idx = unwrap(branch_index)
    idx = int(idx.reshape(()).item()) if isinstance(idx, torch.Tensor) \
        else int(idx)
    fns = dict(branch_fns) if not isinstance(branch_fns, dict) \
        else branch_fns
    fn = fns.get(idx)
    if fn is None:
        return default() if default is not None else None
    return fn()


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """While (static.nn.while_loop, :89). Traced: the ``while_loop``
    higher order op over the carries (each keeps its shape and dtype);
    eager: a Python loop. Returns the final carries as a list."""
    if _traced():
        from torch._higher_order_ops import while_loop as _while

        def loop_cond(*c):
            return unwrap(cond(*_wrap_tree(list(c)))).reshape(()).to(
                torch.bool)

        def loop_body(*c):
            out = body(*_wrap_tree(list(c)))
            out = out if isinstance(out, (list, tuple)) else [out]
            return tuple(_unwrap_tree(list(out)))

        res = _while(loop_cond, loop_body, tuple(_unwrap_tree(
            list(loop_vars))))
        return _wrap_tree(list(res))
    vals = list(loop_vars)
    while _as_bool(cond(*vals)):
        out = body(*vals)
        vals = list(out) if isinstance(out, (list, tuple)) else [out]
    return vals


conv2d_transpose = F.conv2d_transpose
conv3d_transpose = F.conv3d_transpose
layer_norm = F.layer_norm
group_norm = F.group_norm
instance_norm = F.instance_norm
prelu = F.prelu
bilinear_tensor_product = F.bilinear


def data_norm(*a, **kw):
    raise NotImplementedError(
        "data_norm is a PS-era layer; use nn.BatchNorm")


def nce(*a, **kw):
    raise NotImplementedError(
        "NCE sampling loss: compose with paddle.nn.functional ops; the "
        "static param-creating builder has no dygraph analog")


def deform_conv2d(x, offset, mask, num_filters, filter_size, **kw):
    raise NotImplementedError(
        "use paddle.vision.ops.deform_conv2d / DeformConv2D (weights as "
        "explicit Tensors)")


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    raise NotImplementedError(
        "static.nn.fc builds Program variables; use paddle.nn.Linear")


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    """static.nn.embedding creates a Program variable for its table; the
    dygraph path is paddle.nn.Embedding (or F.embedding with a weight)."""
    raise NotImplementedError(
        "static.nn.embedding creates Program variables; use "
        "paddle.nn.Embedding(vocab, dim) or nn.functional.embedding(x, "
        "weight)")


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Run a Python callable over tensors (static.nn.py_func): an eager
    call."""
    return func(x)


def sparse_embedding(*a, **kw):
    raise NotImplementedError("PS sparse table embedding is out of scope")


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """static.nn.spectral_norm: the op library's spectral normalization."""
    from ..ops.linalg import spectral_norm as _sn
    return _sn(weight, dim=dim, power_iters=power_iters, eps=eps)


def row_conv(input, future_context_size, param_attr=None, act=None):
    raise NotImplementedError(
        "row_conv (lookahead conv) predates the jit world; compose with "
        "paddle.nn.functional.conv1d")


def static_pylayer(forward_fn, inputs, backward_fn=None, name=None):
    """static.nn.static_pylayer: dygraph PyLayer covers it; an eager
    call."""
    return forward_fn(*inputs)


def _sequence_unsupported(*a, **kw):
    raise NotImplementedError(
        "LoD sequence ops are a legacy CPU-graph feature; use padded "
        "batches + paddle.nn.functional masks")


sequence_conv = _sequence_unsupported
sequence_expand = _sequence_unsupported
sequence_first_step = _sequence_unsupported
sequence_last_step = _sequence_unsupported
sequence_pool = _sequence_unsupported
sequence_softmax = _sequence_unsupported
