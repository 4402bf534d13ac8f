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

Stage 3 (parameters sharded) raises: it comes with the ZeRO-3 slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..jit.api import TrainStep
from . import mesh as mesh_mod
from .communication import collectives as C
from .fleet.meta_optimizers.dygraph_optimizer.hybrid_parallel_optimizer \
    import FlatParams, _apply_clip, clip_scale


class DistributedTrainStep(TrainStep):
    """``TrainStep`` over the hybrid topology; ``sharding_stage`` 0 / None
    (data parallelism: the optimizer's own stage), 1 or 2 (ZeRO)."""

    def __init__(self, model, loss_fn, optimizer, amp_dtype=None,
                 donate=True, sharding_stage: Optional[int] = None):
        from .fleet.meta_parallel.meta_parallel_base import MetaParallelBase
        inner_model = model._layers if isinstance(model, MetaParallelBase) \
            else model
        inner_opt = getattr(optimizer, "_inner_opt", optimizer)
        stage = sharding_stage if sharding_stage is not None \
            else getattr(inner_opt, "_sharding_stage", 0)
        stage = int(stage or 0)
        if stage >= 3:
            raise NotImplementedError(
                "ZeRO-3 (sharding_stage 3) comes with the pipeline / ZeRO-3 "
                "slice of the port (ROADMAP D2)")
        hcg = mesh_mod.get_hybrid_communicate_group()
        self._mp_group = hcg.get_model_parallel_group()
        self._data_group = hcg.get_dp_sharding_group()
        self._sharding_stage = stage
        self._flat = None
        super().__init__(inner_model, loss_fn, inner_opt, amp_dtype=amp_dtype,
                         donate=donate)
        self._dist = {n: bool(getattr(p, "is_distributed", False))
                      for n, p in self._params.items()}

    def _init_opt_state(self):
        if self._sharding_stage == 0:
            return super()._init_opt_state()
        named = [(n, p, bool(getattr(p, "is_distributed", False)))
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
        the data group); 0-d values and non-arrays pass."""
        g = self._data_group
        if isinstance(x, (list, tuple)):
            return type(x)(self._local(a) for a in x)
        x = getattr(x, "_data", x)
        if g.nranks == 1 or not isinstance(x, (torch.Tensor, np.ndarray)) \
                or x.ndim == 0:
            return x
        n = x.shape[0]
        if n % g.nranks:
            raise ValueError(f"the batch's dim 0 ({n}) must be divisible by "
                             f"the data-parallel degree ({g.nranks})")
        k = n // g.nranks
        return x[g.rank * k:(g.rank + 1) * k]

    @torch.no_grad()
    def _reduce_grads(self, grads):
        g = self._data_group
        if g.nranks == 1:
            return grads
        flat = torch.cat([x.reshape(-1).float() for x in grads])
        C.all_reduce(flat, op=C.ReduceOp.AVG, group=g)
        out, off = [], 0
        for x in grads:
            out.append(flat[off:off + x.numel()].view_as(x).to(x.dtype))
            off += x.numel()
        return out

    def __call__(self, inputs, labels):
        if not isinstance(inputs, (list, tuple)):
            inputs = (inputs,)
        inputs = tuple(self._local(x) for x in inputs)
        labels = self._local(labels)
        loss, names, grads = self._raw_loss_and_grads(inputs, labels)
        clip, lr = self._opt._grad_clip, self._opt.get_lr()
        with torch.no_grad():
            if self._flat is None:
                grads = self._reduce_grads(grads)
                scale = clip_scale(clip, [(g, self._dist[n])
                                          for n, g in zip(names, grads)],
                                   self._mp_group)
                grads = _apply_clip(clip, grads, scale)
                self._opt.apply_gradients_pytree(
                    self._params, dict(zip(names, grads)), self._opt_state,
                    lr)
            else:
                flat = self._flat
                gflat = flat.flat_grad(dict(zip(names, grads)))
                del grads
                gshard = flat.reduce(gflat, self._sharding_stage)
                scale = clip_scale(clip, flat.parts(gshard), self._mp_group,
                                   self._data_group)
                gshard = _apply_clip(clip, [gshard], scale)[0]
                self._opt._apply_updates(
                    [(flat.shard, gshard, self._opt_state["@flat_shard"],
                      torch.float32)], float(lr), self._opt._weight_decay)
                del gflat, gshard
                flat.gather()
            if self._data_group.nranks > 1:
                loss = loss.clone()
                C.all_reduce(loss, op=C.ReduceOp.AVG, group=self._data_group)
        return loss
