"""Tensor-parallel communication ops with their gradients (counterpart
of ``paddle_tpu/distributed/fleet/layers/mpu/mp_ops.py``).

The JAX package states layouts and lets GSPMD insert the collectives and
differentiate them. The port holds local shards, as the reference does,
and writes each pairing of a forward with a different backward as a
``torch.autograd.Function`` over the model-parallel group:

=====================  ==========================  =======================
op                     forward                     backward
=====================  ==========================  =======================
``_c_identity``        identity                    all-reduce (sum)
``_mp_allreduce``      all-reduce (sum)            identity
``_c_split``           this rank's last-dim slice  all-gather (concat)
``_c_concat``          all-gather (concat)         this rank's slice
``_ReduceScatter``     reduce-scatter (sum)        all-gather (concat)
``_AllGatherRS``       all-gather (concat)         reduce-scatter (sum)
=====================  ==========================  =======================

``_Split`` and ``_Concat`` take the dim they act on: -1 for the
tensor-parallel ops above, 1 (the sequence) for the sequence-parallel
ones of ``fleet/utils/sequence_parallel_utils.py``, which also use the
last two.

``_c_lookup_table`` looks ids up in a vocabulary shard (ids outside it
give zero rows); ``_c_softmax_with_cross_entropy`` is the cross entropy
of vocabulary-sharded logits, with three all-reduces (the row max, the
sum of exponentials and the label's logit) and no gather of the logits.
Each takes a surface ``Tensor`` (and returns one) or a torch tensor.
The group defaults to the hybrid topology's model-parallel group, and a
group of one makes every op the plain one.
"""
from __future__ import annotations

import torch

from .....core.dispatch import surface
from .....core.tensor import Tensor
from ....communication import collectives as C


def _mp_group(group=None):
    """``group``, else the model-parallel group of the hybrid topology
    (None without one: no model parallelism)."""
    if group is not None:
        return group
    from .... import mesh as mesh_mod
    if mesh_mod.get_mesh() is None or mesh_mod.axis_degree("mp") == 1:
        return None
    return mesh_mod.get_hybrid_communicate_group().get_model_parallel_group()


def _n(group):
    return 1 if group is None else group.nranks


def _all_reduce(x, group):
    out = x.contiguous().clone()
    C.all_reduce(out, group=group)
    return out


def _gather(x, group, dim):
    parts = C.all_gather(None, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _my_slice(x, group, dim):
    n = group.nranks
    w = x.shape[dim] // n
    return x.narrow(dim, group.rank * w, w).contiguous()


def _reduce_scatter(x, group, dim):
    """The group's sum of ``x``, this rank's slice of ``dim``."""
    n = group.nranks
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter: dim {dim} ({x.shape[dim]}) must "
                         f"be divisible by the group size ({n})")
    whole = x.movedim(dim, 0).contiguous()
    out = whole.new_empty((whole.shape[0] // n,) + tuple(whole.shape[1:]))
    C.reduce_scatter(out, whole, group=group)
    return out.movedim(0, dim).contiguous()


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _my_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _my_slice(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """The ranks' partial sums reduced, this rank's slice of ``dim`` kept;
    the backward all-gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _AllGatherRS(torch.autograd.Function):
    """All-gather on ``dim`` whose consumers hold parts of its gradient
    (a column-parallel product): the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def _apply(name, fn, tensor, group, *extra):
    g = _mp_group(group)
    if _n(g) == 1:
        return tensor
    return surface(name, lambda x: fn.apply(x, g, *extra), [tensor])


def _c_identity(tensor, group=None, skip_c_identity_dynamic=False):
    """Forward identity, backward all-reduce over the mp group: the input
    of a column-parallel product, whose gradient each rank holds a part
    of."""
    return _apply("c_identity", _Identity, tensor, group)


def _mp_allreduce(tensor, op=None, group=None, use_calc_stream=True,
                  use_model_parallel=True):
    """Forward all-reduce (sum), backward identity: the output of a
    row-parallel product."""
    return _apply("mp_allreduce", _AllReduce, tensor, group)


def _c_split(tensor, group=None):
    """This rank's slice of the last dim; the backward gathers."""
    return _apply("c_split", _Split, tensor, group, -1)


def _c_concat(tensor, group=None):
    """The ranks' last-dim slices concatenated; the backward slices."""
    return _apply("c_concat", _Concat, tensor, group, -1)


def _c_lookup_table(table, index, start_index=0, vocab_size=-1, name=None):
    """Rows of a vocabulary shard: ``table`` holds rows [start_index,
    start_index + rows); ids outside give zero rows (the caller's
    ``_mp_allreduce`` sums the shards' lookups)."""
    def body(t, idx):
        idx = idx.long()
        local = idx - start_index
        inside = (local >= 0) & (local < t.shape[0])
        out = torch.nn.functional.embedding(
            torch.where(inside, local, torch.zeros_like(local)), t)
        return out * inside[..., None].to(out.dtype)
    return surface("c_lookup_table", body, [table, index])


class _VocabParallelCE(torch.autograd.Function):
    """CE of vocabulary-sharded f32 logits [rows, V / n]: the row max,
    the sum of exponentials and the label's logit, each all-reduced."""

    @staticmethod
    def forward(ctx, logits, labels, group, start, vocab, ignore_index):
        lg = logits.float()
        m = lg.max(dim=-1).values
        m = _reduce(m, group, C.ReduceOp.MAX)
        e = torch.exp(lg - m[:, None])
        s = _reduce(e.sum(dim=-1), group)
        local = labels - start
        inside = (local >= 0) & (local < lg.shape[-1])
        safe = torch.where(inside, local, torch.zeros_like(local))
        picked = torch.where(inside, lg.gather(-1, safe[:, None])[:, 0],
                             torch.zeros_like(m))
        picked = _reduce(picked, group)
        valid = (labels != ignore_index) & (labels >= 0) & (labels < vocab)
        loss = torch.where(valid, torch.log(s) + m - picked,
                           torch.zeros_like(m))
        ctx.save_for_backward(e, s, safe, inside, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, safe, inside, valid = ctx.saved_tensors
        d = e / s[:, None]
        d.scatter_add_(-1, safe[:, None], -inside.float()[:, None])
        d.mul_((g.float() * valid.float())[:, None])
        return d.to(ctx.dtype), None, None, None, None, None


def _reduce(x, group, op=C.ReduceOp.SUM):
    if _n(group) > 1:
        x = x.contiguous()
        C.all_reduce(x, op=op, group=group)
    return x


def _c_softmax_with_cross_entropy(logits, label, group=None,
                                  return_softmax=False, ignore_index=-100):
    """The softmax cross entropy of logits whose last dim is this rank's
    vocabulary shard (rank r holds [r V/n, (r+1) V/n)). ``label`` [...]
    or [..., 1] (then the loss keeps the trailing 1); an ``ignore_index``
    label gives 0. ``return_softmax`` also returns this rank's shard of
    the softmax."""
    g = _mp_group(group)

    def body(lg, lb):
        lb = lb.long()
        keep = lb.dim() == lg.dim()
        if keep:
            lb = lb[..., 0]
        n = _n(g)
        vl = lg.shape[-1]
        start = 0 if n == 1 else g.rank * vl
        rows = lg.reshape(-1, vl)
        loss = _VocabParallelCE.apply(rows, lb.reshape(-1), g, start,
                                      vl * n, ignore_index)
        loss = loss.reshape(lb.shape)
        return loss[..., None] if keep else loss

    loss = surface("c_softmax_with_cross_entropy", body, [logits, label])
    if not return_softmax:
        return loss
    lg = logits._data if isinstance(logits, Tensor) else logits
    with torch.no_grad():
        lf = lg.float()
        m = _reduce(lf.max(dim=-1).values, g, C.ReduceOp.MAX)
        e = torch.exp(lf - m[..., None])
        sm = e / _reduce(e.sum(dim=-1), g)[..., None]
    return loss, (Tensor._from_data(sm) if isinstance(logits, Tensor)
                  else sm)


def mark_sharding(x, *entries):
    """State ``x``'s layout, one mesh axis name (or None) a dim: the
    port's tensors are this rank's shards already, so nothing moves; the
    entries are checked against the hybrid axes and kept on the tensor
    as ``dist_layout``."""
    from ....mesh import HYBRID_AXES
    for e in entries:
        for ax in (e if isinstance(e, tuple) else (e,)):
            if ax is not None and ax not in HYBRID_AXES:
                raise ValueError(f"mark_sharding: unknown axis {ax!r}")
    data = x._data if isinstance(x, Tensor) else x
    try:
        data.dist_layout = tuple(entries)
    except (AttributeError, RuntimeError):
        pass
    return x
