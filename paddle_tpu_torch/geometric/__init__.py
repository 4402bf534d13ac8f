"""paddle.geometric of the port (counterpart of
``paddle_tpu/geometric/__init__.py``; the reference's
python/paddle/geometric): segment pooling, message passing and the
neighbour samplers.

The segment ops read ``max(segment_ids)`` on the host once a call, as the
JAX package does. Sums are ``index_add`` (atomics on the card: the last
bits of a sum may differ from the CPU's); max / min are
``scatter_reduce`` over a buffer filled with JAX's identity, so an empty
segment holds -inf / +inf (the dtype's extreme for integers) where the
reference Paddle writes 0, and a tie splits the gradient evenly as
``jax.ops.segment_max``'s does. The samplers draw on the host from
``core.random.numpy_generator()``, which ``paddle.seed`` sets; the JAX
package's draw from an unseeded generator.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import run_op, unwrap

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min",
           "send_u_recv", "send_ue_recv", "send_uv", "sample_neighbors",
           "weighted_sample_neighbors", "reindex_graph",
           "reindex_heter_graph"]


def _num_segments(segment_ids):
    return int(unwrap(segment_ids).max()) + 1


def _seg_sum(d, s, n):
    out = d.new_zeros((n,) + tuple(d.shape[1:]))
    return out.index_add(0, s.to(torch.int64), d)


def _seg_mean(d, s, n):
    tot = _seg_sum(d, s, n)
    cnt = _seg_sum(torch.ones(s.shape, dtype=d.dtype, device=d.device), s, n)
    return tot / torch.clamp_min(cnt.reshape((n,) + (1,) * (d.dim() - 1)), 1)


def _seg_extreme(d, s, n, largest):
    if d.is_floating_point():
        fill = float("-inf") if largest else float("inf")
    else:
        info = torch.iinfo(d.dtype)
        fill = info.min if largest else info.max
    out = torch.full((n,) + tuple(d.shape[1:]), fill, dtype=d.dtype,
                     device=d.device)
    idx = s.to(torch.int64).reshape((-1,) + (1,) * (d.dim() - 1)).expand(
        d.shape)
    return out.scatter_reduce(0, idx, d, "amax" if largest else "amin",
                              include_self=True)


def _gather(a, idx):
    """The rows ``a[idx]`` by ``index_select``, whose backward is an
    ``index_add`` (atomics). Advanced indexing's backward accumulates by
    sorting and serialises the duplicates of one row: a power-law graph's
    hub, gathered once an edge, makes that path many times slower."""
    return a.index_select(0, idx.to(torch.int64).reshape(-1)).reshape(
        tuple(idx.shape) + tuple(a.shape[1:]))


_REDUCE = {"sum": _seg_sum, "mean": _seg_mean,
           "max": lambda d, s, n: _seg_extreme(d, s, n, True),
           "min": lambda d, s, n: _seg_extreme(d, s, n, False)}


def segment_sum(data, segment_ids, name=None):
    n = _num_segments(segment_ids)
    return run_op("segment_pool", lambda d, s: _seg_sum(d, s, n),
                  [data, segment_ids])


def segment_mean(data, segment_ids, name=None):
    n = _num_segments(segment_ids)
    return run_op("segment_pool", lambda d, s: _seg_mean(d, s, n),
                  [data, segment_ids])


def segment_max(data, segment_ids, name=None):
    n = _num_segments(segment_ids)
    return run_op("segment_pool", lambda d, s: _REDUCE["max"](d, s, n),
                  [data, segment_ids])


def segment_min(data, segment_ids, name=None):
    n = _num_segments(segment_ids)
    return run_op("segment_pool", lambda d, s: _REDUCE["min"](d, s, n),
                  [data, segment_ids])


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Message passing: gather the source rows, reduce them at the
    destinations (sum / mean / max / min)."""
    n = out_size or int(unwrap(x).shape[0])
    red = _REDUCE[reduce_op]
    return run_op("send_u_recv",
                  lambda a, si, di: red(_gather(a, si), di, n),
                  [x, src_index, dst_index])


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """Messages combine the source rows with the edge features ``y``
    (added for "add", multiplied otherwise), then reduce."""
    n = out_size or int(unwrap(x).shape[0])
    red = _REDUCE[reduce_op]

    def fn(a, e, si, di):
        msgs = _gather(a, si)
        msgs = msgs + e if message_op == "add" else msgs * e
        return red(msgs, di, n)
    return run_op("send_ue_recv", fn, [x, y, src_index, dst_index])


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """One message per edge from both endpoints' rows (no reduce)."""
    ops = {"add": torch.add, "sub": torch.subtract, "mul": torch.multiply,
           "div": torch.true_divide}
    if message_op not in ops:
        raise ValueError(f"message_op must be one of {sorted(ops)}")

    def fn(a, b, si, di):
        return ops[message_op](_gather(a, si), _gather(b, di))
    return run_op("send_uv", fn, [x, y, src_index, dst_index])


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """CSC neighbour sampling (``incubate.graph_sample_neighbors``)."""
    from ..incubate.graph import graph_sample_neighbors
    return graph_sample_neighbors(row, colptr, input_nodes, eids=eids,
                                  sample_size=sample_size,
                                  return_eids=return_eids)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None,
                              return_eids=False, name=None):
    """Neighbour sampling without replacement, biased by the edge
    weights."""
    from ..incubate.graph import _host, _sampled
    return _sampled(row, colptr, input_nodes, eids, sample_size, return_eids,
                    weights=_host(edge_weight).astype(np.float64))


def reindex_graph(x, neighbors, count, value_buffer=None,
                  index_buffer=None, name=None):
    """``incubate.graph_reindex``."""
    from ..incubate.graph import graph_reindex
    return graph_reindex(x, neighbors, count)


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """Reindex per-relation neighbour lists against one shared node
    set."""
    from ..incubate.graph import _host, _out
    x_np = _host(x).reshape(-1)
    uniq = list(dict.fromkeys(x_np.tolist()))
    seen = {v: i for i, v in enumerate(uniq)}
    srcs, dsts = [], []
    for nb, ct in zip(neighbors, count):
        nb_np, ct_np = _host(nb), _host(ct)
        for v in nb_np.tolist():
            if v not in seen:
                seen[v] = len(uniq)
                uniq.append(v)
        srcs.append(np.asarray([seen[v] for v in nb_np.tolist()],
                               np.int64))
        dsts.append(np.repeat(np.arange(len(x_np)), ct_np))
    return (_out(np.concatenate(srcs)),
            _out(np.concatenate(dsts).astype(np.int64)),
            _out(np.asarray(uniq, x_np.dtype)))
