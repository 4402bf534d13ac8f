"""Search / sort ops (counterpart of ``paddle_tpu/ops/search.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import run_op, run_op_nodiff, unwrap, wrap
from ..core.tensor import Tensor


def _arg(fn, x, axis, keepdim, dtype):
    def body(a):
        if axis is None:
            out = fn(a.reshape(-1))
            return out.reshape((1,) * a.dim()) if keepdim else out
        return fn(a, dim=axis, keepdim=keepdim)
    out = run_op_nodiff(fn.__name__, body, [x])
    return out.astype(dtype) if dtype != "int64" else out


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return run_op_nodiff("argsort", lambda a: torch.argsort(
        a, dim=axis, descending=descending, stable=True), [x])


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return run_op("sort", lambda a: torch.sort(
        a, dim=axis, descending=descending, stable=True).values, [x])


def topk(x, k, axis=None, largest=True, sorted=True, name=None):  # noqa: A002
    kk = int(unwrap(k)) if not isinstance(k, int) else k

    def fn(a):
        ax = axis if axis is not None else a.dim() - 1
        vals, idx = torch.topk(a, kk, dim=ax, largest=largest, sorted=True)
        return vals, idx.to(torch.int64)
    return run_op("topk", fn, [x])


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def fn(a):
        srt, idx = torch.sort(a, dim=axis, stable=True)
        vals = srt.narrow(axis, k - 1, 1)
        inds = idx.narrow(axis, k - 1, 1)
        if not keepdim:
            vals, inds = vals.squeeze(axis), inds.squeeze(axis)
        return vals, inds.to(torch.int64)
    return run_op("kthvalue", fn, [x])


def mode(x, axis=-1, keepdim=False, name=None):
    """Most frequent value along ``axis`` on the host (ties resolve to
    the largest value, its last index), as the JAX package's."""
    a = Tensor._from_data(unwrap(x)).numpy()
    moved = np.moveaxis(a, axis, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    vals, inds = [], []
    for row in flat:
        uniq, counts = np.unique(row, return_counts=True)
        best = uniq[len(counts) - 1 - np.argmax(counts[::-1])]
        vals.append(best)
        inds.append(np.max(np.nonzero(row == best)[0]))
    vals = np.array(vals).reshape(moved.shape[:-1])
    inds = np.array(inds).reshape(moved.shape[:-1])
    if keepdim:
        vals = np.expand_dims(vals, axis)
        inds = np.expand_dims(inds, axis)
    dev = unwrap(x).device
    return (wrap(torch.as_tensor(vals, device=dev)),
            wrap(torch.as_tensor(inds.astype(np.int64), device=dev)))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return run_op_nodiff("searchsorted", lambda s, v: torch.searchsorted(
        s, v, out_int32=out_int32, right=right), [sorted_sequence, values])


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right, name)


def index_sample(x, index):
    from .manipulation import index_sample as _is
    return _is(x, index)


def masked_select(x, mask, name=None):
    from .manipulation import masked_select as _ms
    return _ms(x, mask, name)


def where(condition, x=None, y=None, name=None):
    from .manipulation import where as _w
    return _w(condition, x, y, name)


def nonzero(x, as_tuple=False):
    from .manipulation import nonzero as _nz
    return _nz(x, as_tuple)


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True, name=None):
    """Viterbi decoding: potentials [B, T, N], transition_params [N, N],
    lengths [B]; the last transition row is the start tag and the
    second-to-last column the stop tag when ``include_bos_eos_tag``.
    Returns (scores [B], paths [B, T])."""
    def fn(em, trans, *rest):
        B, T, N = em.shape
        lens = rest[0] if rest else torch.full((B,), T, device=em.device)
        score = em[:, 0]
        if include_bos_eos_tag:
            score = score + trans[-1]
        ptrs = []
        ident = torch.arange(N, device=em.device).expand(B, N)
        for t in range(1, T):
            cand = score[:, :, None] + trans[None]
            best, idx = cand.max(dim=1)
            best = best + em[:, t]
            valid = (t < lens)[:, None]
            score = torch.where(valid, best, score)
            ptrs.append(torch.where(valid, idx, ident))
        if include_bos_eos_tag:
            score = score + trans[:, -2]
        last = score.argmax(dim=1)
        path = [last]
        for p in reversed(ptrs):
            last = torch.take_along_dim(p, last[:, None], dim=1)[:, 0]
            path.append(last)
        return score.max(dim=1).values, torch.stack(path[::-1], dim=1)
    args = [potentials, transition_params] + (
        [lengths] if lengths is not None else [])
    return run_op_nodiff("viterbi_decode", fn, args)


def gather_tree(ids, parents, name=None):
    """Beam-search backtrace; ids / parents [T, B, beam]."""
    def fn(ids_a, par):
        beams = torch.arange(ids_a.shape[2], device=ids_a.device).expand(
            ids_a.shape[1:]).to(ids_a.dtype)
        outs = []
        for t in range(ids_a.shape[0] - 1, -1, -1):
            outs.append(torch.take_along_dim(ids_a[t], beams, dim=1))
            beams = torch.take_along_dim(par[t], beams, dim=1)
        return torch.stack(outs[::-1])
    return run_op_nodiff("gather_tree", fn, [ids, parents])
