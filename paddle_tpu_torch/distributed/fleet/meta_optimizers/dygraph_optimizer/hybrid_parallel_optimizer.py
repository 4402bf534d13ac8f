"""HybridParallelOptimizer, the ZeRO-1/2 sharding optimizers and the
grad scaler (counterpart of ``paddle_tpu/distributed/fleet/
meta_optimizers/dygraph_optimizer/hybrid_parallel_optimizer.py``;
reference hybrid_parallel_optimizer.py:266,
dygraph_sharding_optimizer.py:54 and :586).

The JAX package's compiled step sees the full global gradient, so its
global-norm clip needs no bookkeeping (:1-14). The port's ranks hold
shards, so ``hybrid_global_norm`` does the reference's
``HybridParallelClipGrad._global_norm``: the squared norms of the
``is_distributed`` (mp-sharded) parameters are summed over the mp
group, the replicated ones (norm weights) counted once, and under ZeRO,
where each rank holds a slice of every gradient, both sums are first
summed over the data group. Expert-parallel parameters (an MoE layer's
rows of experts, split over the ``ep`` group) are summed over that group,
each shard once.

The gradient policy of the data and sequence splits, stated here and
applied by every step (this module's optimizers, ``DistributedTrainStep``;
``reduce_data_grads``): a data rank's gradient is that of its part of
the batch, so the data group (dp x sharding) averages them; a sep rank's
is its chunk's part of the gradient of the whole sequence's loss, so the
sep group sums them. The loss a sep rank returns must therefore be the
sequence's, with its chunk's true gradient: ``fused_linear_cross_entropy``
with ``seq_group`` (LLaMA's loss under sep; the model refuses to hand out
chunk logits for a loss of the caller's). The gradients of the
sequence-parallel parameters (``mark_as_sequence_parallel_parameter``:
norms applied to an mp rank's sequence rows) are summed over the mp
group first, once (``sum_sequence_parallel_grads``).

``FlatParams`` is the ZeRO layout: every trainable f32 parameter of the
model becomes a view into one flat buffer, padded to a multiple of the
data group's size; data rank r owns elements [r N / n, (r+1) N / n).
A ZeRO step reduces the flat gradient over the data group (stage 1: an
all-reduce, of which a rank keeps its slice; stage 2: a reduce-scatter),
updates its slice of the parameters with the optimizer's rule on a
slice-sized state (Adam / AdamW: the port's fused Adam kernel, one
launch; the update is elementwise), then all-gathers the parameters.
So a rank holds 1/n of the optimizer state, and every rank ends the step
with the same parameters.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .....nn.clip import ClipGradByGlobalNorm, ClipGradByNorm
from .... import mesh as mesh_mod
from ....communication import collectives as C
from ...meta_parallel.meta_parallel_base import is_distributed, is_expert
from ...utils.sequence_parallel_utils import (
    allreduce_sequence_parallel_grads, is_sequence_parallel_parameter)

#: a ZeRO slice is a multiple of this many elements (32-byte vectors)
_ALIGN = 64


def _trivial(group) -> bool:
    return group is None or group.nranks == 1


def hybrid_global_norm(parts, mp_group=None, data_group=None,
                       ep_group=None) -> torch.Tensor:
    """The global L2 norm (f32) of a gradient held in ``parts``: (tensor,
    is_distributed[, is_expert]) of this rank. ``data_group``: the parts
    are this rank's ZeRO slices, summed over the group first; the
    mp-sharded squares are summed over ``mp_group``, the expert shards'
    over ``ep_group``, the replicated ones counted once."""
    dev = parts[0][0].device
    sq = torch.zeros(3, dtype=torch.float32, device=dev)
    for part in parts:
        g, is_dist = part[0], part[1]
        if g is not None and g.numel():
            kind = 2 if len(part) > 2 and part[2] else (0 if is_dist else 1)
            sq[kind] += torch.sum(torch.square(g.float()))
    if not _trivial(data_group):
        C.all_reduce(sq, group=data_group)
    for i, group in ((0, mp_group), (2, ep_group)):
        if not _trivial(group):
            part_sq = sq[i:i + 1].clone()
            C.all_reduce(part_sq, group=group)
            sq = torch.cat([sq[:i], part_sq, sq[i + 1:]])
    return torch.sqrt(sq.sum())


def clip_scale(clip, parts, mp_group=None, data_group=None, ep_group=None):
    """The factor ``clip`` scales every gradient by, or None for no
    global clip. A per-tensor or value clip acts on each tensor alone:
    ``ClipGradByNorm`` of a sharded tensor is refused."""
    if clip is None:
        return None
    if isinstance(clip, ClipGradByGlobalNorm):
        gn = hybrid_global_norm(parts, mp_group, data_group, ep_group)
        return clip.clip_norm / torch.clamp(gn, min=clip.clip_norm)
    if isinstance(clip, ClipGradByNorm) and (
            not _trivial(data_group)
            or (not _trivial(mp_group) and any(p[1] for p in parts))
            or (not _trivial(ep_group)
                and any(len(p) > 2 and p[2] for p in parts))):
        raise NotImplementedError(
            "ClipGradByNorm of sharded gradients: use ClipGradByGlobalNorm "
            "or ClipGradByValue under model parallelism or ZeRO")
    return None


def _apply_clip(clip, grads, scale):
    """Clip a list of gradients: by ``scale`` (a global norm) or by the
    clip's own per-tensor rule."""
    if clip is None:
        return grads
    if scale is not None:
        return [None if g is None else (g.float() * scale).to(g.dtype)
                for g in grads]
    return clip.clip_grads(grads)


class FlatParams:
    """The trainable parameters of a model as views of one flat f32
    buffer, sliced over ``group`` (the data group)."""

    def __init__(self, named: List[Tuple[str, torch.Tensor, bool]], group):
        self.group = group
        self.n = 1 if group is None else group.nranks
        self.rank = 0 if group is None else group.rank
        dev = named[0][1].device
        for name, p, _ in named:
            if p.dtype != torch.float32 or p.device != dev:
                raise ValueError(
                    f"ZeRO flattens float32 parameters of one device; "
                    f"{name} is {p.dtype} on {p.device}")
        self.segments = []
        off = 0
        for name, p, is_dist in named:
            self.segments.append((name, off, p.numel(), is_dist))
            off += p.numel()
        unit = self.n * _ALIGN
        self.numel = -(-off // unit) * unit
        self.flat = torch.zeros(self.numel, dtype=torch.float32, device=dev)
        with torch.no_grad():
            for (name, o, k, _), (_, p, _) in zip(self.segments, named):
                self.flat[o:o + k].copy_(p.reshape(-1))
                p.data = self.flat[o:o + k].view_as(p)
        self.shard_numel = self.numel // self.n
        self.lo = self.rank * self.shard_numel
        self.hi = self.lo + self.shard_numel

    @property
    def shard(self) -> torch.Tensor:
        """This rank's slice of the parameters (a view)."""
        return self.flat[self.lo:self.hi]

    def flat_grad(self, grads: Dict[str, Optional[torch.Tensor]]):
        g = torch.zeros(self.numel, dtype=torch.float32,
                        device=self.flat.device)
        for name, o, k, _ in self.segments:
            gi = grads.get(name)
            if gi is not None:
                g[o:o + k].copy_(gi.reshape(-1))
        return g

    def reduce(self, gflat, stage: int) -> torch.Tensor:
        """This rank's slice of the data-group mean of ``gflat``."""
        if self.n == 1:
            return gflat
        if stage >= 2:
            out = torch.empty(self.shard_numel, dtype=gflat.dtype,
                              device=gflat.device)
            C.reduce_scatter(out, gflat, op=C.ReduceOp.AVG, group=self.group)
            return out
        C.all_reduce(gflat, op=C.ReduceOp.AVG, group=self.group)
        return gflat[self.lo:self.hi]

    def parts(self, gshard) -> List[Tuple[torch.Tensor, bool]]:
        """(piece, is_distributed) of each parameter's share of
        ``gshard``, this rank's slice of the flat gradient."""
        out = []
        for _, o, k, is_dist in self.segments:
            a, b = max(o, self.lo), min(o + k, self.hi)
            if a < b:
                out.append((gshard[a - self.lo:b - self.lo], is_dist))
        return out

    @torch.no_grad()
    def gather(self):
        """Every rank's slice of the parameters, into every rank's flat
        buffer."""
        if self.n == 1:
            return
        views = list(self.flat.chunk(self.n))
        C.all_gather(views, self.shard.clone(), group=self.group)


def _groups(hcg):
    hcg = hcg or mesh_mod.get_hybrid_communicate_group()
    return hcg.get_model_parallel_group(), hcg.get_dp_sharding_group()


def grad_groups(hcg=None):
    """(the group a gradient is reduced over: dp x sharding, x sep when
    the sequence is split; the sep group or None; the ep group or None)."""
    hcg = hcg or mesh_mod.get_hybrid_communicate_group()
    sep = hcg.get_sep_parallel_group() \
        if mesh_mod.axis_degree("sep") > 1 else None
    ep = hcg.get_expert_parallel_group() \
        if mesh_mod.axis_degree("ep") > 1 else None
    data = hcg.get_data_sep_group() if sep is not None \
        else hcg.get_dp_sharding_group()
    return data, sep, ep


@torch.no_grad()
def reduce_data_grads(flat, group, sep_group=None):
    """``flat``, this rank's gradients, reduced in place by the policy of
    the module docstring: summed over ``group`` (dp x sharding, x sep when
    ``sep_group`` is given) and divided by its dp x sharding degree."""
    if _trivial(group):
        return flat
    if sep_group is None:
        C.all_reduce(flat, op=C.ReduceOp.AVG, group=group)
        return flat
    C.all_reduce(flat, group=group)
    n = group.nranks // sep_group.nranks
    if n > 1:
        flat.div_(n)
    return flat


def sum_sequence_parallel_grads(pairs, mp_group):
    """Sum over the mp group the gradients of the sequence-parallel
    parameters among ``pairs`` ((param, grad)): the one place they are
    summed."""
    allreduce_sequence_parallel_grads(
        [g for p, g in pairs if is_sequence_parallel_parameter(p)
         or is_sequence_parallel_parameter(getattr(p, "_data", p))],
        mp_group)


class _OptimizerWrapper:
    """Delegating wrapper; ``_inner_opt`` is the user's optimizer."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    @property
    def inner_opt(self):
        return self._inner_opt

    def minimize(self, loss, *args, **kwargs):
        loss.backward()
        self.step()

    def clear_grad(self, *args, **kwargs):
        return self._inner_opt.clear_grad(*args, **kwargs)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)

    def _params(self):
        return [p for p in self._inner_opt._parameter_list
                if p.requires_grad]


class HybridParallelOptimizer(_OptimizerWrapper):
    """The eager step under hybrid parallelism (reference :266): the
    gradients averaged over the data group (unless a ``DataParallel``
    wrapper did it in the backward), clipped with the hybrid global
    norm, then the inner optimizer's step."""

    sharding_stage = 0

    def __init__(self, optimizer, hcg=None, strategy=None):
        super().__init__(optimizer, hcg, strategy)
        optimizer._sharding_stage = self.sharding_stage

    @torch.no_grad()
    def step(self):
        mp_group, _ = _groups(self._hcg)
        data_group, sep_group, ep_group = grad_groups(self._hcg)
        params = [p for p in self._params() if p.grad is not None]
        if not params:
            return
        sum_sequence_parallel_grads([(p, p.grad) for p in params], mp_group)
        if not _trivial(data_group) and not all(
                getattr(p, "_dp_reduced", False) for p in params):
            flat = torch.cat([p.grad.reshape(-1).float() for p in params])
            reduce_data_grads(flat, data_group, sep_group)
            off = 0
            for p in params:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
                off += p.numel()
        inner = self._inner_opt
        clip = inner._grad_clip
        scale = clip_scale(clip, [(p.grad, is_distributed(p), is_expert(p))
                                  for p in params], mp_group,
                           ep_group=ep_group)
        if scale is not None:
            for p in params:
                p.grad.mul_(scale.to(p.grad.dtype))
            inner._grad_clip = None
        try:
            inner.step()
        finally:
            inner._grad_clip = clip


class DygraphShardingOptimizer(HybridParallelOptimizer):
    """ZeRO-1 (reference :54): the optimizer state of 1/n of the flat
    parameters a data rank; the gradients all-reduced."""

    sharding_stage = 1

    def __init__(self, optimizer, hcg=None, strategy=None):
        super().__init__(optimizer, hcg, strategy)
        optimizer._sharded = True
        self._flat = None
        self._state = None

    @torch.no_grad()
    def step(self):
        mp_group, data_group = _groups(self._hcg)
        _, sep_group, ep_group = grad_groups(self._hcg)
        if ep_group is not None:
            raise NotImplementedError(
                "ZeRO-1/2 with expert parallelism: the flat slices would mix "
                "the ep ranks' expert shards")
        inner = self._inner_opt
        params = self._params()
        sum_sequence_parallel_grads([(p, p.grad) for p in params
                                     if p.grad is not None], mp_group)
        if self._flat is None:
            self._flat = FlatParams(
                [(str(i), p, is_distributed(p))
                 for i, p in enumerate(params)], data_group)
            self._state = inner._init_state(self._flat.shard)
        flat = self._flat
        gflat = flat.flat_grad({str(i): p.grad for i, p in enumerate(params)})
        if sep_group is not None:
            # summed over sep, then averaged over the data group
            C.all_reduce(gflat, group=sep_group)
        gshard = flat.reduce(gflat, self.sharding_stage)
        clip = inner._grad_clip
        scale = clip_scale(clip, flat.parts(gshard), mp_group, data_group)
        gshard = _apply_clip(clip, [gshard], scale)[0]
        inner._apply_updates([(flat.shard, gshard, self._state,
                               torch.float32)], inner.get_lr(),
                             inner._weight_decay)
        flat.gather()
        inner._global_step += 1


class DygraphShardingOptimizerV2(DygraphShardingOptimizer):
    """ZeRO-2 (reference :586): the gradients reduce-scattered."""

    sharding_stage = 2


class GroupShardedOptimizerStage3(HybridParallelOptimizer):
    """The eager step of a ZeRO-3 model (``group_sharded_parallel``
    "p_g_os"; reference group_sharded_stage3.py): the backward already
    averaged the gradients (the slices' reduce-scattered, the whole
    parameters' all-reduced), so the step takes the ZeRO-3 global norm
    for the clip and runs the inner optimizer on the slices (its state
    slice-sized)."""

    sharding_stage = 3

    @torch.no_grad()
    def step(self):
        mp_group, _ = _groups(self._hcg)
        params = [p for p in self._params() if p.grad is not None]
        if not params:
            return
        z = params[0].__dict__.get("_zero3")
        inner = self._inner_opt
        clip = inner._grad_clip
        scale = None if z is None else z.clip_scale(
            clip, [(p.grad, is_distributed(p),
                    z.is_whole(p)) for p in params], mp_group)
        if scale is not None:
            for p in params:
                p.grad.mul_(scale.to(p.grad.dtype))
            inner._grad_clip = None
        try:
            inner.step()
        finally:
            inner._grad_clip = clip


class HybridParallelGradScaler:
    """The grad scaler under hybrid parallelism (reference
    hybrid_parallel_gradscaler.py): the found-inf flag is OR-ed over the
    world after the unscale, so that every rank skips the same steps."""

    def __init__(self, scaler, hcg=None):
        self._scaler = scaler
        self._hcg = hcg

    def __getattr__(self, item):
        return getattr(self._scaler, item)

    def scale(self, var):
        return self._scaler.scale(var)

    def unscale_(self, optimizer):
        from .....amp.grad_scaler import OptimizerState
        from ....communication.group import _get_global_group
        from .... import env
        inner = getattr(optimizer, "_inner_opt", optimizer)
        sc = self._scaler
        if sc._opt_states.get(id(inner)) == OptimizerState.UNSCALED:
            return
        sc.unscale_(inner)
        dev = env.device() if env.backend() == "nccl" else "cpu"
        t = torch.tensor([1.0 if sc._found_inf else 0.0], device=dev)
        C.all_reduce(t, op=C.ReduceOp.MAX, group=_get_global_group())
        sc._found_inf = bool(t.item())

    def step(self, optimizer):
        from .....amp.grad_scaler import OptimizerState
        sc = self._scaler
        if not sc._enable:
            optimizer.step()
            return
        inner = getattr(optimizer, "_inner_opt", optimizer)
        if sc._opt_states.get(id(inner)) != OptimizerState.UNSCALED:
            self.unscale_(optimizer)
        if not sc._found_inf:
            optimizer.step()
        sc._opt_states[id(inner)] = OptimizerState.STEPPED

    def update(self):
        self._scaler.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()
