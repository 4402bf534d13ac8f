"""DataParallel, TensorParallel and ShardingParallel (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_wrappers.py``;
reference parallel.py:219, meta_parallel/tensor_parallel.py:28,
sharding_parallel.py).

The JAX package's wrappers commit shardings and leave the gradient
reduction to GSPMD; its parameters are global, so nothing is broadcast.
The port's ranks each hold their model, so the wrappers do what the
reference's do:

- ``DataParallel`` broadcasts the parameters and buffers from the data
  group's first rank at wrap time, then averages each gradient over the
  data group as the backward produces it: the parameters are cut, in
  reverse order, into buckets of ``comm_buffer_size`` MB (the first one
  ``last_comm_buffer_size``), and a bucket is flattened and all-reduced
  once each of its gradients has been accumulated; what the backward
  did not reach is reduced at its end (as zeros). ``no_sync()`` skips the
  reduction (the gradients accumulate locally until a synchronised
  backward averages the sums); ``scale_loss`` returns the loss, as the
  average is taken on the gradients.
- ``TensorParallel`` broadcasts every parameter that is not
  ``is_distributed`` (norms, row-parallel biases) from the mp group's
  first rank, and every parameter from the data group's first rank.
- ``ShardingParallel`` broadcasts every parameter from the sharding
  group's first rank.

``SegmentParallel`` (sequence parallelism) and ``shard_parameters_fsdp``
(ZeRO-3) raise: they come with the sequence-parallel and pipeline
slices.
"""
from __future__ import annotations

import contextlib

import torch

from ... import mesh as mesh_mod
from ...communication import collectives as C
from ...communication.group import _get_global_group
from .meta_parallel_base import MetaParallelBase, torch_buffers, torch_params


def _broadcast_all(tensors, group):
    if group is None or group.pg is None:
        return
    for t in tensors:
        C.broadcast(t, src=group.ranks[0], group=group)


def _data_group():
    if mesh_mod.get_mesh() is None:
        return _get_global_group()
    return mesh_mod.get_hybrid_communicate_group().get_dp_sharding_group()


class DataParallel(MetaParallelBase):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, **kwargs):
        self._group = group if group is not None else _data_group()
        self.find_unused_parameters = find_unused_parameters
        self._comm_mb = (float(comm_buffer_size),
                         float(last_comm_buffer_size))
        super().__init__(layers, strategy=strategy)

    def _prepare_for_model(self):
        params = [t for _, t, _ in torch_params(self._layers)]
        with torch.no_grad():
            _broadcast_all(params + torch_buffers(self._layers), self._group)
        self._sync = True
        self._pending = False
        trainable = [p for p in params if p.requires_grad]
        self._buckets, cur, cap = [], [], self._comm_mb[1] * 2 ** 20
        size = 0
        for p in reversed(trainable):
            cur.append(p)
            size += p.numel() * p.element_size()
            if size >= cap:
                self._buckets.append(cur)
                cur, size, cap = [], 0, self._comm_mb[0] * 2 ** 20
        if cur:
            self._buckets.append(cur)
        self._bucket_of = {id(p): i for i, b in enumerate(self._buckets)
                           for p in b}
        self._ready = [set() for _ in self._buckets]
        self._done = [False] * len(self._buckets)
        if self._group.nranks > 1:
            for p in trainable:
                p.register_post_accumulate_grad_hook(self._grad_ready)

    def _grad_ready(self, p):
        if not self._sync:
            return
        if not self._pending:
            self._pending = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish_backward)
        i = self._bucket_of[id(p)]
        self._ready[i].add(id(p))
        if len(self._ready[i]) == len(self._buckets[i]):
            self._reduce_bucket(i)

    @torch.no_grad()
    def _reduce_bucket(self, i):
        grads = []
        for p in self._buckets[i]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        flat = torch.cat([g.reshape(-1) for g in grads])
        C.all_reduce(flat, op=C.ReduceOp.AVG, group=self._group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        self._done[i] = True

    def _finish_backward(self):
        for i, done in enumerate(self._done):
            if not done:
                self._reduce_bucket(i)
        self._ready = [set() for _ in self._buckets]
        self._done = [False] * len(self._buckets)
        self._pending = False

    def scale_loss(self, loss):
        return loss

    @contextlib.contextmanager
    def no_sync(self):
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev


class TensorParallel(MetaParallelBase):
    def _prepare_for_model(self):
        hcg = self._hcg or mesh_mod.get_hybrid_communicate_group()
        params = torch_params(self._layers)
        with torch.no_grad():
            _broadcast_all([t for _, t, d in params if not d],
                           hcg.get_model_parallel_group())
            _broadcast_all([t for _, t, _ in params]
                           + torch_buffers(self._layers),
                           hcg.get_dp_sharding_group())


class ShardingParallel(MetaParallelBase):
    def _prepare_for_model(self):
        hcg = self._hcg or mesh_mod.get_hybrid_communicate_group()
        with torch.no_grad():
            _broadcast_all([t for _, t, _ in torch_params(self._layers)]
                           + torch_buffers(self._layers),
                           hcg.get_dp_sharding_group())


class SegmentParallel(MetaParallelBase):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SegmentParallel (the sequence dim split over 'sep') comes with "
            "the sequence-parallel slice of the port (ROADMAP D3)")


def shard_parameters_fsdp(layer, axis="sharding"):
    raise NotImplementedError(
        "ZeRO-3 (parameters sharded over 'sharding') comes with the "
        "pipeline / ZeRO-3 slice of the port (ROADMAP D2)")
