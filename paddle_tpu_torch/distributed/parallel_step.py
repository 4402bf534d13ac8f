"""DistributedTrainStep, the hybrid-parallel train step (counterpart of
``paddle_tpu/distributed/parallel_step.py``).

The JAX step is one jitted program over global arrays: the batch is
sharded over the data axes (``_batch_sharding``, :37-46) and GSPMD emits
every collective. The port's runs on each rank:

1. the global batch's dim 0 is split over the data group (the ranks with
   the same model shard: dp x sharding), this rank taking its part;
2. forward, loss and backward as ``TrainStep``'s (the tensor-parallel
   layers' collectives inside);
3. the gradients are averaged over the data group: stage 0 all-reduces
   them (one flat buffer); stages 1 and 2 are ZeRO (``FlatParams``):
   stage 1 all-reduces the flat gradient and keeps this rank's slice,
   stage 2 reduce-scatters it;
4. the optimizer's ``grad_clip``, with the hybrid global norm
   (``hybrid_global_norm``: mp-sharded squares summed over the mp group,
   replicated ones once, ZeRO slices over the data group);
5. the update: stage 0 the fused update of every parameter; stages 1-2
   the fused update of this rank's slice, on a slice-sized state, then
   an all-gather of the parameters, so every rank leaves the step with
   the same parameters;
6. the loss averaged over the data group (the global batch's mean when
   the ranks' parts count the same tokens).

Sequence parallelism over ``sep`` (a mesh sep degree > 1): every tensor
input of two or more dims (the ids, the labels) is also split along dim
1 over the sep group, this rank taking its chunk of the sequence (the
model's attention is then the ring, ``kernels.ring_attention``); the
gradients are summed over sep and averaged over dp x sharding (the
policy of ``hybrid_parallel_optimizer``'s docstring: a sep rank's loss
is the sequence's, its gradient its chunk's part); ZeRO-1/2 sum the
flat gradient over sep before their data-group reduction; ZeRO-3 with
sep raises. The loss, the same on the sep ranks, is averaged over the
data group. Sequence-parallel parameters (norms on an mp rank's
sequence rows) have their gradients summed over the mp group before the
clip. Expert-parallel parameters (an MoE layer's experts over ``ep``)
count once a shard in the global norm (summed over the ep group); ZeRO
with ep raises.

Stage 3 (ZeRO-3, Paddle's group_sharded_stage3): the model's parameters
are sliced over the data group (``shard_parameters_fsdp``, unless
``fleet.distributed_model`` or ``group_sharded_parallel`` did it) and
gathered layer by layer in the forward and again in the backward; the
slices' gradients come out of the backward reduce-scattered (averaged),
the unsliced parameters' are averaged after it; the global norm sums the
slices' squares over the data group; the update (the fused kernel, one
launch) runs on this rank's slices, with slice-sized optimizer state, and
nothing is gathered after it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..jit.api import TrainStep
from . import mesh as mesh_mod
from .communication import collectives as C
from .fleet.meta_optimizers.dygraph_optimizer.hybrid_parallel_optimizer \
    import (FlatParams, _apply_clip, clip_scale, grad_groups,
            reduce_data_grads, sum_sequence_parallel_grads)
from .fleet.meta_parallel.meta_parallel_base import (check_sequence_split,
                                                     is_distributed,
                                                     is_expert)


class DistributedTrainStep(TrainStep):
    """``TrainStep`` over the hybrid topology; ``sharding_stage`` 0 / None
    (data parallelism: the optimizer's own stage), 1, 2 or 3 (ZeRO)."""

    def __init__(self, model, loss_fn, optimizer, amp_dtype=None,
                 donate=True, sharding_stage: Optional[int] = None):
        from .fleet.meta_parallel.meta_parallel_base import MetaParallelBase
        inner_model = model._layers if isinstance(model, MetaParallelBase) \
            else model
        inner_opt = getattr(optimizer, "_inner_opt", optimizer)
        stage = sharding_stage if sharding_stage is not None \
            else getattr(inner_opt, "_sharding_stage", 0)
        stage = int(stage or 0)
        hcg = mesh_mod.get_hybrid_communicate_group()
        self._mp_group = hcg.get_model_parallel_group()
        self._data_group = hcg.get_dp_sharding_group()
        self._grad_group, self._sep_group, self._ep_group = grad_groups(hcg)
        if stage >= 3 and self._sep_group is not None:
            raise NotImplementedError(
                "ZeRO-3 with sequence parallelism over sep: use sharding "
                "stage 0, 1 or 2 with sep > 1")
        if stage >= 1 and self._ep_group is not None:
            raise NotImplementedError(
                "ZeRO with expert parallelism: the slices would mix the ep "
                "ranks' expert shards")
        if self._sep_group is not None:
            check_sequence_split(inner_model, self._sep_group)
        self._sharding_stage = stage
        self._flat = None
        self._zero3 = None
        if stage >= 3:
            from .fleet.meta_parallel.parallel_wrappers import (
                shard_parameters_fsdp, zero3_of)
            if zero3_of(inner_model) is None:
                shard_parameters_fsdp(inner_model, axis=("dp", "sharding"))
            self._zero3 = zero3_of(inner_model)
        super().__init__(inner_model, loss_fn, inner_opt, amp_dtype=amp_dtype,
                         donate=donate)
        self._dist = {n: (is_distributed(p), is_expert(p))
                      for n, p in self._params.items()}

    def _init_opt_state(self):
        if self._sharding_stage in (0, 3):
            return super()._init_opt_state()     # ZeRO-3: on the slices
        named = [(n, p, is_distributed(p))
                 for n, p in self._params.items()]
        self._flat = FlatParams(named, self._data_group)
        return {"@flat_shard": self._opt._init_state(self._flat.shard)}

    def opt_state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds."""
        return sum(t.numel() * t.element_size()
                   for slots in self._opt_state.values()
                   for t in slots.values())

    def _local(self, x):
        """This rank's part of a global batch tensor (dim 0 split over
        the data group, dim 1 over the sep group); 0-d values and
        non-arrays pass."""
        if isinstance(x, (list, tuple)):
            return type(x)(self._local(a) for a in x)
        x = getattr(x, "_data", x)
        if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim == 0:
            return x
        x = _part_of(x, 0, self._data_group, "the data-parallel degree")
        if self._sep_group is not None and x.ndim >= 2:
            x = _part_of(x, 1, self._sep_group, "the sep degree")
        return x

    @torch.no_grad()
    def _reduce_grads(self, grads):
        g = self._grad_group
        if g.nranks == 1:
            return grads
        flat = reduce_data_grads(
            torch.cat([x.reshape(-1).float() for x in grads]), g,
            self._sep_group)
        out, off = [], 0
        for x in grads:
            out.append(flat[off:off + x.numel()].view_as(x).to(x.dtype))
            off += x.numel()
        return out

    def parameter_bytes(self) -> dict:
        """Bytes of parameters this rank holds (ZeRO-3: its slices and
        the unsliced remainder)."""
        if self._zero3 is not None:
            return self._zero3.resident_bytes()
        n = sum(p.numel() * p.element_size() for p in self._params.values())
        return {"sliced": 0, "whole": n, "total": n}

    def full_parameters(self) -> dict:
        """{name: the whole parameter}; ZeRO-3 gathers the slices (every
        rank of the data group must call it)."""
        if self._zero3 is not None:
            return self._zero3.full_parameters()
        return {n: p.detach() for n, p in self._params.items()}

    def _zero3_loss_and_grads(self, inputs, labels):
        """The forward with the parameters gathered by the ZeRO-3 hooks
        (in the AMP dtype), the f32 loss's gradients on the slices."""
        z = self._zero3
        dev = self._device
        inputs = tuple(self._cast(torch.as_tensor(getattr(x, "_data", x),
                                                  device=dev))
                       for x in inputs)
        labels = torch.as_tensor(getattr(labels, "_data", labels),
                                 device=dev)
        names = list(self._params)
        masters = [self._params[n] for n in names]
        z.amp = self._amp_dtype
        try:
            with torch.enable_grad():
                out = self._model(*inputs)
                loss = self._loss_fn(out, labels)
                loss = getattr(loss, "_data", loss).float()
                grads = list(torch.autograd.grad(loss, masters,
                                                 materialize_grads=True))
        finally:
            z.amp = None
        whole = {id(p) for _, p in z.whole}
        z.reduce_whole([g for n, g in zip(names, grads)
                        if id(self._params[n]) in whole])
        return loss.detach(), names, grads

    def _zero3_clip_scale(self, clip, names, grads):
        z = self._zero3
        return z.clip_scale(clip, [(g, self._dist[n][0],
                                    z.is_whole(self._params[n]))
                                   for n, g in zip(names, grads)],
                            self._mp_group)

    def __call__(self, inputs, labels):
        if not isinstance(inputs, (list, tuple)):
            inputs = (inputs,)
        inputs = tuple(self._local(x) for x in inputs)
        labels = self._local(labels)
        if self._zero3 is not None:
            loss, names, grads = self._zero3_loss_and_grads(inputs, labels)
            clip, lr = self._opt._grad_clip, self._opt.get_lr()
            with torch.no_grad():
                self._sum_sp(names, grads)
                scale = self._zero3_clip_scale(clip, names, grads)
                grads = _apply_clip(clip, grads, scale)
                self._opt.apply_gradients_pytree(
                    self._params, dict(zip(names, grads)), self._opt_state,
                    lr)
                if self._data_group.nranks > 1:
                    loss = loss.clone()
                    C.all_reduce(loss, op=C.ReduceOp.AVG,
                                 group=self._data_group)
            return loss
        loss, names, grads = self._raw_loss_and_grads(inputs, labels)
        clip, lr = self._opt._grad_clip, self._opt.get_lr()
        with torch.no_grad():
            self._sum_sp(names, grads)
            if self._flat is None:
                grads = self._reduce_grads(grads)
                scale = clip_scale(clip, [(g,) + self._dist[n]
                                          for n, g in zip(names, grads)],
                                   self._mp_group, ep_group=self._ep_group)
                grads = _apply_clip(clip, grads, scale)
                self._opt.apply_gradients_pytree(
                    self._params, dict(zip(names, grads)), self._opt_state,
                    lr)
            else:
                flat = self._flat
                gflat = flat.flat_grad(dict(zip(names, grads)))
                del grads
                if self._sep_group is not None:
                    # summed over sep, then averaged over the data group
                    C.all_reduce(gflat, group=self._sep_group)
                gshard = flat.reduce(gflat, self._sharding_stage)
                scale = clip_scale(clip, flat.parts(gshard), self._mp_group,
                                   self._data_group)
                gshard = _apply_clip(clip, [gshard], scale)[0]
                self._opt._apply_updates(
                    [(flat.shard, gshard, self._opt_state["@flat_shard"],
                      torch.float32)], float(lr), self._opt._weight_decay)
                del gflat, gshard
                flat.gather()
            if self._grad_group.nranks > 1:
                loss = loss.clone()
                C.all_reduce(loss, op=C.ReduceOp.AVG, group=self._grad_group)
        return loss

    def _sum_sp(self, names, grads):
        """The sequence-parallel parameters' gradients summed over mp."""
        sum_sequence_parallel_grads(
            [(self._params[n], g) for n, g in zip(names, grads)],
            self._mp_group)


def _part_of(x, dim, group, what):
    """Group rank ``group.rank``'s part of ``x`` along ``dim``."""
    if group.nranks == 1:
        return x
    n = x.shape[dim]
    if n % group.nranks:
        raise ValueError(f"the batch's dim {dim} ({n}) must be divisible by "
                         f"{what} ({group.nranks})")
    k = n // group.nranks
    return x[(slice(None),) * dim + (slice(group.rank * k,
                                          (group.rank + 1) * k),)]
