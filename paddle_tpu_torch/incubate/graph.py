"""Incubate graph sampling ops (counterpart of
``paddle_tpu/incubate/graph.py``; the reference's
python/paddle/incubate/operators/graph_khop_sampler.py,
graph_sample_neighbors.py and graph_reindex.py).

Sampling has data-dependent shapes: it runs on the host in numpy, as the
reference's CPU path does, and returns tensors on the current place.
The draws come from ``core.random.numpy_generator()`` (``paddle.seed``
sets it); the JAX package draws from an unseeded generator, so the two
agree on the samples' properties, not their bits. ``graph_reindex`` is
deterministic and bit-equal to the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import place as place_mod
from ..core.dispatch import unwrap, wrap
from ..core.random import numpy_generator

__all__ = ["graph_sample_neighbors", "graph_reindex", "graph_khop_sampler"]


def _host(x):
    x = unwrap(x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _out(a):
    return wrap(torch.from_numpy(np.ascontiguousarray(a)).to(
        place_mod.current_device()))


def _sample(row_np, colptr_np, nodes, eids_np, sample_size, weights=None):
    """numpy (neighbors, counts int32, eids or None) of the nodes; picks
    biased by the edges' ``weights`` when given (uniform where a node's
    weights sum to 0)."""
    out_neighbors, out_counts, out_eids = [], [], []
    rng = numpy_generator()
    for n in nodes.reshape(-1):
        beg, end = int(colptr_np[n]), int(colptr_np[n + 1])
        neigh = row_np[beg:end]
        idx = np.arange(beg, end)
        if 0 < sample_size < len(neigh):
            p = None
            if weights is not None and weights[beg:end].sum() > 0:
                p = weights[beg:end] / weights[beg:end].sum()
            pick = rng.choice(len(neigh), sample_size, replace=False, p=p)
            neigh, idx = neigh[pick], idx[pick]
        out_neighbors.append(neigh)
        out_counts.append(len(neigh))
        if eids_np is not None:
            out_eids.append(eids_np[idx])
    neighbors = np.concatenate(out_neighbors) if out_neighbors \
        else np.zeros(0, row_np.dtype)
    eids = np.concatenate(out_eids) if eids_np is not None and out_eids \
        else None
    return neighbors, np.asarray(out_counts, np.int32), eids


def _sampled(row, colptr, input_nodes, eids, sample_size, return_eids,
             weights=None):
    """``_sample`` on the host copies, as (neighbors, count[, eids])
    tensors on the current place."""
    eids_np = _host(eids) if eids is not None else None
    neighbors, counts, out_eids = _sample(
        _host(row), _host(colptr), _host(input_nodes), eids_np, sample_size,
        weights)
    if return_eids:
        if eids_np is None:
            raise ValueError("return_eids requires eids")
        return _out(neighbors), _out(counts), _out(out_eids)
    return _out(neighbors), _out(counts)


def graph_sample_neighbors(row, colptr, input_nodes, eids=None,
                           perm_buffer=None, sample_size=-1,
                           return_eids=False, flag_perm_buffer=False,
                           name=None):
    """Sample up to ``sample_size`` neighbours of each input node of a CSC
    graph, without replacement. Returns (neighbors, count[, eids])."""
    return _sampled(row, colptr, input_nodes, eids, sample_size,
                    return_eids)


def graph_reindex(x, neighbors, count, value_buffer=None, index_buffer=None,
                  flag_buffer_hashtable=False, name=None):
    """Reindex a sampled subgraph to local ids, the input nodes first.
    Returns (reindex_src, reindex_dst, out_nodes)."""
    x_np, neigh, cnt = _host(x).reshape(-1), _host(neighbors), _host(count)
    uniq = list(dict.fromkeys(x_np.tolist()))
    seen = {v: i for i, v in enumerate(uniq)}
    for v in neigh.tolist():
        if v not in seen:
            seen[v] = len(uniq)
            uniq.append(v)
    reindex_src = np.asarray([seen[v] for v in neigh.tolist()], np.int64)
    dst = np.repeat(np.arange(len(x_np)), cnt)
    return (_out(reindex_src), _out(dst.astype(np.int64)),
            _out(np.asarray(uniq, x_np.dtype)))


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """Multi-hop neighbour sampling, then a reindex over the union (the
    seeds first). Returns (edge_src, edge_dst, sample_index,
    reindex_nodes[, edge_eids])."""
    if return_eids and sorted_eids is None:
        raise ValueError("return_eids requires eids")
    row_np, colptr_np = _host(row), _host(colptr)
    eids_np = _host(sorted_eids) if return_eids else None
    frontier = _host(input_nodes).reshape(-1)
    all_src, all_dst, all_eids = [], [], []
    for size in sample_sizes:
        neigh_np, cnt_np, eids = _sample(row_np, colptr_np, frontier,
                                         eids_np, size)
        if return_eids:
            all_eids.append(eids)
        all_src.append(neigh_np)
        all_dst.append(np.repeat(frontier, cnt_np))
        frontier = np.unique(np.concatenate([frontier, neigh_np]))
    src = np.concatenate(all_src) if all_src else np.zeros(0, np.int64)
    dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int64)
    seeds = _host(input_nodes).reshape(-1)
    uniq = list(dict.fromkeys(seeds.tolist()))
    seen = {v: i for i, v in enumerate(uniq)}
    for v in np.concatenate([src, dst]).tolist():
        if v not in seen:
            seen[v] = len(uniq)
            uniq.append(v)
    r_src = np.asarray([seen[v] for v in src.tolist()], np.int64)
    r_dst = np.asarray([seen[v] for v in dst.tolist()], np.int64)
    out = (_out(r_src), _out(r_dst), _out(np.asarray(uniq, np.int64)),
           _out(np.asarray([seen[v] for v in seeds.tolist()], np.int64)))
    if return_eids:
        return out + (_out(np.concatenate(all_eids)),)
    return out
