"""PipelineParallel: the pipeline training wrapper (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``;
reference pipeline_parallel.py:255, train_batch :820).

The JAX package compiles the whole step, the schedule a ``lax.scan`` over
the 'pp' axis with the prefix and suffix replicated. The port runs
Paddle's runtime, one pp rank a process:

- **placement.** The blocks (``PipelineLayer.pipelinable_run``, trimmed
  to a multiple of S*V) are cut into S*V even chunks, chunk c = v*S + s
  on stage s (the round-robin of the interleaved schedule); the items
  before them join chunk 0 (the embedding, on stage 0) and the items
  after them the last chunk (the final norm, the head and the loss, on
  the last stage). An explicit list of stage sizes (``seg_method``, no
  VPP) places the items by it, as Paddle does: a heterogeneous stage is
  native here, each rank owning different layers (``het_pipeline``).
  Each rank keeps only its chunks' modules; the others are dropped.
- **the step.** ``train_batch`` splits the batch into
  ``accumulate_steps`` microbatches and runs this stage's program of the
  schedule's event graph (``mpmd_graph``) with ``pipeline.StageRunner``:
  forwards and backwards in the graph's order, boundary activations and
  their gradients by isend / irecv. The last chunk's forward ends in the
  microbatch's loss over M (a head with a ``pipe_loss``, the LLaMA head
  under ``fused_linear_ce``, computes it fused); the loss is their sum,
  the mean of the microbatch losses as in the JAX step, and every pp rank
  returns it (a broadcast from the last stage). The weights' gradients
  accumulate over the microbatches in ``.grad``.
- **after the schedule.** Shared weights (a tied embedding) sum their
  gradients over the stages holding them; the data group (dp) averages
  the gradients; the optimizer's ``grad_clip`` takes the global norm
  over every stage (and the mp shards), a shared weight counted once;
  then this rank's parameters get the optimizer's update
  (``apply_gradients_pytree``: AdamW's fused kernel, one launch).
- **schedules.** "FThenB" (and "": VPP when vpp_degree > 1), "1F1B" (a
  real one-forward-one-backward order: stage s holds at most S-s live
  activations), "VPP", "ZBH1" and "ZBVPP" (the weight gradients in the w
  events of the drain bubble, ``zero_bubble``), all on the pp ranks;
  "MPMD", "MPMD-VPP", "MPMD-ZBH1" and "MPMD-ZBVPP" run the same graphs
  in ONE process on ``mpmd_runtime.MpmdDriver``, stage s on
  ``stage_devices(S)[s]`` (pp_degree 1; the PipelineLayer's num_stages
  is S).
- **mixed precision.** ``amp_dtype`` (or, through ``fleet``, a strategy
  with ``amp`` on: bfloat16 when ``amp_configs["use_bf16"]``, else
  float16) runs each chunk on weights cast to it, the f32 masters taking
  the gradients, as ``TrainStep(amp_dtype=...)`` does.

The constructor's checks and messages are the JAX package's (:90-186).
With pp_degree 1 (and no MPMD mode) the whole model is one stage: the
microbatches are gradient accumulation. Not ported: pp with a sharding
degree above 1 (ZeRO inside a pipeline) raises.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List

import torch
from torch import nn

from .... import monitor
from ... import mesh as mesh_mod
from ...mpmd_graph import schedule_graph
from ...pipeline import (StageOps, StageRunner, merge_microbatches,
                         split_microbatches)
from .meta_parallel_base import MetaParallelBase, is_distributed
from .pp_layers import PipelineLayer, apply_item, item_module

_MODES = ("", "FTHENB", "1F1B", "VPP", "ZBH1", "ZBVPP", "MPMD", "MPMD-VPP",
          "MPMD-ZBH1", "MPMD-ZBVPP")


def _uniform_bounds(n_items: int, n_stages: int):
    per, rem = divmod(n_items, n_stages)
    bounds = [0]
    for st in range(n_stages):
        bounds.append(bounds[-1] + per + (1 if st < rem else 0))
    return bounds


def _amp_of(strategy):
    if strategy is None or not getattr(strategy, "amp", False):
        return None
    cfg = getattr(strategy, "amp_configs", {}) or {}
    return torch.bfloat16 if cfg.get("use_bf16", True) else torch.float16


class _Chunk(nn.Module):
    """A chunk's items as one module (the functional call binds their
    cast weights by these names)."""

    def __init__(self, items):
        super().__init__()
        self.items = list(items)
        mods = []
        for it in self.items:
            m = item_module(it)
            if m is not None and not any(m is k for k in mods):
                mods.append(m)
        self.mods = nn.ModuleList(mods)

    def forward(self, x, labels=None, loss_fn=None):
        items = self.items
        fused = None
        if labels is not None and items:
            fused = _pipe_loss(items[-1])
            if fused is not None:
                items = items[:-1]
        for it in items:
            x = apply_item(it, x)
        if labels is None:
            return x
        if fused is not None:
            return fused(x, labels)
        return loss_fn(x, labels)


def _pipe_loss(item):
    """The fused loss ``f(x, labels)`` a last item offers, or None."""
    if isinstance(item, tuple):
        lyr, ffn = item
        fl = getattr(ffn, "pipe_loss", None)
        return None if fl is None else (lambda x, lab: fl(lyr, x, lab))
    return getattr(item, "pipe_loss", None)


def _loss_value(loss):
    loss = getattr(loss, "_data", loss)
    return loss.float()


class _PipeOps(StageOps):
    """The stage ops of a train step: chunk forwards on cast weights,
    the last one ending in the microbatch's loss / M."""

    def __init__(self, pipe, chunks, xs, labs, loss_fn, M, last_v, scale,
                 grad=True):
        self.pipe, self.chunks, self.xs, self.labs = pipe, chunks, xs, labs
        self.loss_fn, self.M, self.last_v = loss_fn, M, last_v
        self.scale = scale
        self.grad = grad
        self.losses: List[torch.Tensor] = []
        self.outs: Dict[int, Any] = {}

    def feed(self, m):
        return self.xs[m] if not isinstance(self.xs, tuple) \
            else tuple(x[m] for x in self.xs)

    def forward(self, v, m, x):
        lab = None
        if v == self.last_v and self.labs is not None:
            lab = self.labs[m] if not isinstance(self.labs, tuple) \
                else tuple(a[m] for a in self.labs)
        y = self.pipe._run_chunk(self.chunks[v], x, lab, self.loss_fn)
        if v != self.last_v:
            return y
        if lab is None:
            self.outs[m] = y.detach()
            return y
        loss = _loss_value(y) / self.M
        self.losses.append(loss.detach())
        return loss * self.scale if self.scale is not None else loss

    def params(self, v):
        return [p for p in self.chunks[v].parameters() if p.requires_grad]


class PipelineParallel(MetaParallelBase):
    """Wraps a PipelineLayer; ``train_batch`` runs the schedule."""

    def __init__(self, layers, hcg=None, strategy=None, amp_dtype=None,
                 **kwargs):
        if not isinstance(layers, PipelineLayer):
            raise TypeError(
                "pipeline parallel requires the model to be a PipelineLayer "
                "(reference fleet/model.py:32 has the same requirement)")
        if mesh_mod.axis_degree("sep") > 1:
            raise NotImplementedError(
                "a pipeline over a sep mesh: the stages' ring attention "
                "and the sequence-wide loss are not carried (pp with "
                "sep > 1)")
        super().__init__(layers, hcg=hcg, strategy=strategy)
        self._pp = mesh_mod.axis_degree("pp")
        if self._pp > 1 and layers.get_num_stages() != self._pp:
            raise ValueError(
                f"PipelineLayer was built for {layers.get_num_stages()} "
                f"stages but the mesh 'pp' axis has degree {self._pp}; "
                "make them match (num_stages defaults to the mesh degree)")
        cfg = getattr(strategy, "pipeline_configs", None) or {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1) or 1)
        if self.accumulate_steps < self._pp:
            self.accumulate_steps = max(self._pp, self.accumulate_steps)
        layer_v = int(getattr(layers, "_num_virtual_stages", 1) or 1)
        cfg_v = int(cfg.get("vpp_degree", 1) or 1)
        if layer_v > 1 and cfg_v > 1 and layer_v != cfg_v:
            raise ValueError(
                f"conflicting vpp degrees: PipelineLayer has "
                f"num_virtual_pipeline_stages={layer_v} but strategy "
                f"pipeline_configs['vpp_degree']={cfg_v}")
        self.vpp_degree = layer_v if layer_v > 1 else cfg_v
        self.schedule_mode = str(cfg.get("schedule_mode", "")).upper()
        if self.schedule_mode not in _MODES:
            raise ValueError(
                f"unknown pipeline schedule_mode "
                f"{cfg.get('schedule_mode')!r}: expected FThenB, 1F1B, "
                "VPP, ZBH1, ZBVPP or an MPMD variant (MPMD, MPMD-VPP, "
                "MPMD-ZBH1, MPMD-ZBVPP)")
        if self.schedule_mode in ("ZBH1", "MPMD-ZBH1") \
                and self.vpp_degree > 1:
            raise ValueError(
                f"schedule_mode={self.schedule_mode!r} is incompatible "
                "with vpp_degree>1 "
                "(use ZBVPP for the interleaved zero-bubble schedule)")
        if self.schedule_mode in ("ZBVPP", "MPMD-ZBVPP", "MPMD-VPP") \
                and self.vpp_degree <= 1:
            raise ValueError(
                f"schedule_mode={self.schedule_mode!r} needs "
                "vpp_degree>1 (set num_virtual_pipeline_stages or "
                "pipeline_configs['vpp_degree'])")
        self._mpmd = self.schedule_mode.startswith("MPMD")
        self._het = self._needs_het()
        if self._het and self.schedule_mode == "ZBH1":
            raise ValueError(
                "schedule_mode='ZBH1' is incompatible with non-uniform "
                "seg_method stage bounds (the het schedule is "
                "GPipe-based); use uniform segmentation with ZBH1")
        if self._het and self._mpmd:
            raise ValueError(
                "MPMD schedule modes need uniform stage bounds (the "
                "per-stage programs share one compiled executable "
                "family); use uniform segmentation")
        if self._mpmd and self._pp > 1:
            raise ValueError(
                "MPMD schedule modes drive every stage from one process "
                "(stage s on stage_devices(S)[s]): run them with "
                "pp_degree 1; the pp ranks run the other modes")
        if self._pp > 1 and mesh_mod.axis_degree("sharding") > 1:
            raise NotImplementedError(
                "pipeline parallelism with a sharding degree above 1 (ZeRO "
                "inside a pipeline) is not ported: use dp_degree for the "
                "data parallelism of a pipeline")
        self._amp = amp_dtype if amp_dtype is not None else _amp_of(strategy)
        if isinstance(self._amp, str):
            self._amp = getattr(torch, self._amp)
        # S stages: the pp ranks', or (MPMD) the PipelineLayer's own
        self._S = layers.get_num_stages() if self._mpmd else max(self._pp, 1)
        hcg = self._hcg or (mesh_mod.get_hybrid_communicate_group()
                            if mesh_mod.get_mesh() is not None else None)
        self._hcg = hcg
        self._stage = hcg.get_stage_id() if (hcg is not None
                                             and self._pp > 1) else 0
        self._pp_group = hcg.get_pipe_parallel_group() \
            if (hcg is not None and self._pp > 1) else None
        self._data_group = hcg.get_dp_sharding_group() \
            if hcg is not None else None
        self._mp_group = hcg.get_model_parallel_group() \
            if hcg is not None else None
        self._ranges = self._placement()
        self._place_stages()
        self._graphs: Dict[Any, Any] = {}
        self._runners: Dict[Any, StageRunner] = {}
        self._opt_state = None
        self._opt_state_owner = None
        self.last_runner = None

    # -- placement -----------------------------------------------------------
    def _needs_het(self):
        pl = self._layers
        S = pl.get_num_stages() if self._mpmd else self._pp
        if S <= 1 or self.vpp_degree > 1:
            return False
        if not isinstance(pl._seg_method, (list, tuple)):
            return False
        return pl._stage_bounds != _uniform_bounds(len(pl._items), S)

    def _placement(self):
        """{(stage, v): (lo, hi)} item ranges of every chunk."""
        pl: PipelineLayer = self._layers
        S, V = self._S, self.vpp_degree
        n = len(pl._items)
        if isinstance(pl._seg_method, (list, tuple)) and V == 1 and S > 1:
            b = pl._stage_bounds
            return {(s, 0): (b[s], b[s + 1]) for s in range(S)}
        lo, hi = pl.pipelinable_run()
        run_len = hi - lo
        if run_len >= S * V:
            run_len -= run_len % (S * V)
            hi = lo + run_len
        else:
            if S > 1 and V > 1:
                raise ValueError(
                    f"vpp_degree={V} needs at least pp*vpp="
                    f"{S * V} homogeneous blocks; run has {run_len}")
            if S == 1:
                return {(0, 0): (0, n)}
            b = pl._stage_bounds
            return {(s, 0): (b[s], b[s + 1]) for s in range(S)}
        if S > 1 and V == 1 and pl._seg_method != "uniform" and \
                not isinstance(pl._seg_method, (list, tuple)) and \
                pl._stage_bounds != _uniform_bounds(n, S):
            warnings.warn(
                "the schedule uses uniform chunks over the homogeneous run "
                f"[{lo}:{hi}]; seg_method={pl._seg_method!r} stage bounds "
                f"{pl._stage_bounds} are honored only for an explicit "
                "per-stage size list", stacklevel=3)
        chunk = run_len // (S * V)
        out = {}
        for c in range(S * V):
            a, b = lo + c * chunk, lo + (c + 1) * chunk
            if c == 0:
                a = 0
            if c == S * V - 1:
                b = n
            out[(c % S, c // S)] = (a, b)
        return out

    def _stages_here(self):
        return range(self._S) if self._mpmd else [self._stage]

    def chunk_items(self, stage: int, v: int = 0):
        lo, hi = self._ranges[(stage, v)]
        return self._layers._items[lo:hi]

    def _place_stages(self):
        """Keep this process's chunks' modules (MPMD: every stage's, each
        on its stage's device); make the shared-weight groups."""
        pl: PipelineLayer = self._layers
        V = self.vpp_degree
        self._chunks: Dict[tuple, _Chunk] = {}
        for s in self._stages_here():
            for v in range(V):
                self._chunks[(s, v)] = _Chunk(self.chunk_items(s, v))
        keep = {id(m) for c in self._chunks.values() for m in c.mods}
        for name in [k for k, m in pl._modules.items() if id(m) not in keep]:
            del pl._modules[name]
        self._devices = None
        if self._mpmd:
            from ...mpmd_runtime import stage_devices
            dev = self._model_device()
            self._devices = stage_devices(self._S, None if dev.type == "cuda"
                                          else [dev])
            for (s, v), c in self._chunks.items():
                c.to(self._devices[s])
            for key, lyr in pl._shared_layers.items():
                devs = {str(self._devices[s]) for (s, v), c in
                        self._chunks.items() if any(m is lyr
                                                    for m in c.mods)}
                if len(devs) > 1:
                    raise NotImplementedError(
                        f"shared layer {key!r} is used by stages on "
                        f"{sorted(devs)}: an MPMD pipeline keeps a shared "
                        "layer on one device")
        self._shared_once = set()   # ids of shared weights counted here
        for key, lyr in pl._shared_layers.items():
            holders = sorted({s for (s, v) in self._ranges
                              if any(item_module(it) is lyr
                                     for it in self.chunk_items(s, v))})
            w = getattr(lyr, pl._shared_attrs[key])
            group = None
            if not self._mpmd and self._pp > 1 and len(holders) > 1:
                group = self._shared_group(holders)
                with torch.no_grad():      # start from one value
                    if self._stage in holders:
                        from ...communication import collectives as C
                        C.broadcast(w, src=group.ranks[0], group=group)
            holds = self._stage in holders or self._mpmd
            pl._shared_comm[key] = (group, holds)
            if self._mpmd or self._stage == holders[0]:
                self._shared_once.add(id(w))

    def _shared_group(self, holders):
        """The group of the pp ranks (this rank's pp slice) of stages
        ``holders``; every rank makes every slice's, in one order."""
        from ...communication.group import new_group
        mesh = mesh_mod.get_mesh()
        mine = None
        for s_ranks in mesh.slices("pp"):
            g = new_group([s_ranks[s] for s in holders])
            if g.is_member():
                mine = g
        return mine

    def _model_device(self):
        for p in self._layers.parameters():
            return p.device
        from ... import env
        return env.device()

    # -- the chunk forward ---------------------------------------------------
    def _run_chunk(self, chunk: _Chunk, x, labels, loss_fn):
        amp = self._amp
        remat = self._layers._recompute_interval > 0

        def run(x, labels):
            if amp is None:
                return chunk(x, labels, loss_fn)
            bound = {n: (p.to(amp) if p.is_floating_point() else p)
                     for n, p in chunk.named_parameters()}
            if amp is not None and isinstance(x, torch.Tensor) \
                    and x.is_floating_point() and x.dtype != amp:
                x = x.to(amp)
            return torch.func.functional_call(chunk, bound,
                                              (x, labels, loss_fn))

        if remat and torch.is_grad_enabled():
            from ..recompute import recompute
            return recompute(run, x, labels)
        return run(x, labels)

    # -- the schedule --------------------------------------------------------
    def _base_mode(self):
        mode = self.schedule_mode
        if mode.startswith("MPMD"):
            return {"MPMD": "VPP" if self.vpp_degree > 1 else "FThenB",
                    "MPMD-VPP": "VPP", "MPMD-ZBH1": "ZBH1",
                    "MPMD-ZBVPP": "ZBVPP"}[mode]
        if mode in ("", "FTHENB"):
            return "VPP" if self.vpp_degree > 1 else "FThenB"
        return {"1F1B": "1F1B", "VPP": "VPP", "ZBH1": "ZBH1",
                "ZBVPP": "ZBVPP"}[mode]

    def _graph(self, mode, M, act_shape=(4, 16), act_dtype="float32"):
        key = (mode, M, tuple(act_shape), act_dtype)
        g = self._graphs.get(key)
        if g is None:
            V = self.vpp_degree if mode in ("VPP", "ZBVPP") else 1
            g = schedule_graph(mode, self._S, M, V, act_shape=act_shape,
                               act_dtype=act_dtype)
            self._graphs[key] = g
        return g

    def _runner(self, mode, M, sig):
        key = (mode, M, sig)
        r = self._runners.get(key)
        if r is None:
            g = self._graph(mode, M)
            ranks = list(self._pp_group.ranks) if self._pp_group is not None \
                else [0]
            r = StageRunner(g, self._stage, ranks, self._pp_group,
                            self._model_device())
            self._runners[key] = r
        return r

    def _local(self, x):
        """This data rank's part of a global batch tensor."""
        g = self._data_group
        if g is None or g.nranks == 1 or not isinstance(x, torch.Tensor) \
                or x.dim() == 0:
            return x
        n = x.shape[0]
        if n % g.nranks:
            raise ValueError(f"the batch's dim 0 ({n}) must be divisible by "
                             f"the data-parallel degree ({g.nranks})")
        k = n // g.nranks
        return x[g.rank * k:(g.rank + 1) * k]

    def _prepare(self, data, M):
        inputs, labels = data
        if not isinstance(inputs, (list, tuple)):
            inputs = (inputs,)
        dev = self._model_device()

        def put(t):
            t = getattr(t, "_data", t)
            return self._local(torch.as_tensor(t, device=dev))

        inputs = tuple(put(t) for t in inputs)
        x = inputs[0] if len(inputs) == 1 else inputs
        xs = split_microbatches(x, M) if not isinstance(x, tuple) \
            else tuple(split_microbatches(a, M) for a in x)
        labs = None
        if labels is not None:
            lab = labels if isinstance(labels, (list, tuple)) else None
            if lab is None:
                labs = split_microbatches(put(labels), M)
            else:
                labs = tuple(split_microbatches(put(a), M) for a in lab)
        sig = tuple((tuple(a.shape), str(a.dtype)) for a in inputs)
        return xs, labs, sig

    def _params(self):
        return {n: p for n, p in self._layers.named_parameters()
                if p.requires_grad}

    def train_batch(self, data, optimizer=None, lr_scheduler=None,
                    scaler=None, loss_fn=None):
        """One pipelined train step over a [batch, ...] global batch
        ``data = (inputs, labels)``; every pp rank returns the loss (an
        f32 0-d tensor)."""
        loss_fn = loss_fn or self._layers._loss_fn
        if loss_fn is None:
            raise ValueError("PipelineLayer needs a loss_fn for train_batch")
        opt = getattr(optimizer, "_inner_opt", optimizer)
        if opt is None:
            raise ValueError("train_batch needs an optimizer")
        M = self.accumulate_steps
        xs, labs, sig = self._prepare(data, M)
        params = self._params()
        for p in params.values():
            p.grad = None
        scale = None
        if scaler is not None and scaler.is_enable():
            scale = float(scaler._scale)
        mode = self._base_mode()
        if self._mpmd:
            loss = self._run_mpmd(mode, M, xs, labs, loss_fn, scale, sig)
        else:
            runner = self._runner(mode, M, sig)
            self.last_runner = runner
            V = self.vpp_degree
            ops = _PipeOps(self, {v: self._chunks[(self._stage, v)]
                                  for v in range(V)}, xs, labs, loss_fn, M,
                           V - 1 if self._stage == self._S - 1 else -1,
                           scale)
            runner.run(ops)
            loss = torch.stack(ops.losses).sum() if ops.losses else \
                torch.zeros((), dtype=torch.float32,
                            device=self._model_device())
            loss = self._broadcast_loss(loss)
            dg = self._data_group
            if dg is not None and dg.nranks > 1:   # the global batch's
                from ...communication import collectives as C
                C.all_reduce(loss, op=C.ReduceOp.AVG, group=dg)
        self._finish_step(opt, params, scale, scaler)
        if lr_scheduler is not None:
            lr_scheduler.step()
        monitor.counter("pipeline.train_batches").increase()
        return loss

    def _broadcast_loss(self, loss):
        g = self._pp_group
        if g is not None and g.nranks > 1:
            from ...communication import collectives as C
            loss = loss.contiguous()
            C.broadcast(loss, src=g.ranks[-1], group=g)
        return loss

    @torch.no_grad()
    def _finish_step(self, opt, params, scale, scaler):
        """The gradients summed (shared weights) and averaged (dp),
        unscaled, clipped, then the update."""
        from ...communication import collectives as C
        from ..meta_optimizers.dygraph_optimizer.hybrid_parallel_optimizer \
            import _apply_clip
        if not self._mpmd:
            self._layers.allreduce_shared_weight_gradients()
        names = list(params)
        grads = [params[n].grad if params[n].grad is not None
                 else torch.zeros_like(params[n]) for n in names]
        dg = self._data_group
        if dg is not None and dg.nranks > 1 and grads:
            flat = torch.cat([g.reshape(-1).float() for g in grads])
            C.all_reduce(flat, op=C.ReduceOp.AVG, group=dg)
            out, off = [], 0
            for g in grads:
                out.append(flat[off:off + g.numel()].view_as(g).to(g.dtype))
                off += g.numel()
            grads = out
        if scale is not None:
            inv = 1.0 / scale
            grads = [g * inv for g in grads]
            found = torch.tensor(
                [0.0 if all(bool(torch.isfinite(g).all()) for g in grads)
                 else 1.0])
            if self._pp_group is not None or (dg is not None
                                              and dg.nranks > 1):
                from ...communication.group import _get_global_group
                from ... import env
                dev = env.device() if env.backend() == "nccl" else "cpu"
                found = found.to(dev)
                C.all_reduce(found, op=C.ReduceOp.MAX,
                             group=_get_global_group())
            scaler._found_inf = bool(found.item())
            scaler.update()
            if scaler._found_inf:
                return
        clip = opt._grad_clip
        if clip is not None:
            scale_c = self._clip_scale(clip, names, params, grads)
            grads = _apply_clip(clip, grads, scale_c)
        if self._opt_state_owner is not opt or self._opt_state is None:
            self._opt_state = opt.init_state_pytree(params)
            self._opt_state_owner = opt
        opt.apply_gradients_pytree(params, dict(zip(names, grads)),
                                   self._opt_state, opt.get_lr())

    def _clip_scale(self, clip, names, params, grads):
        """The global-norm clip's factor over every stage: squares summed
        over the pp group and, for mp-sharded weights, the mp group; a
        shared weight counted on its first stage only."""
        from ....nn.clip import ClipGradByGlobalNorm
        from ...communication import collectives as C
        if not isinstance(clip, ClipGradByGlobalNorm):
            return None
        dev = grads[0].device if grads else self._model_device()
        sq = torch.zeros(2, dtype=torch.float32, device=dev)
        shared = {id(getattr(lyr, self._layers._shared_attrs[k]))
                  for k, lyr in self._layers._shared_layers.items()}
        for n, g in zip(names, grads):
            p = params[n]
            if id(p) in shared and id(p) not in self._shared_once:
                continue
            d = is_distributed(p)
            sq[0 if d else 1] += torch.sum(torch.square(g.float()))
        if self._pp_group is not None and self._pp_group.nranks > 1:
            C.all_reduce(sq, group=self._pp_group)
        mp = self._mp_group
        if mp is not None and mp.nranks > 1:
            d = sq[:1].clone()
            C.all_reduce(d, group=mp)
            sq = torch.cat([d, sq[1:]])
        gn = torch.sqrt(sq.sum())
        return clip.clip_norm / torch.clamp(gn, min=clip.clip_norm)

    # -- the MPMD step: one process, MpmdDriver -----------------------------
    def _run_mpmd(self, mode, M, xs, labs, loss_fn, scale, sig):
        """The graph's events in this process on ``MpmdDriver``, each
        stage's through its own ``_PipeOps`` (the pp ranks' ops)."""
        from ...mpmd_runtime import MpmdDriver, PipelinePrograms
        from ...pipeline import stage_forward
        S, V, devs = self._S, self.vpp_degree, self._devices

        def to(t, dev):
            return tuple(a.to(dev) for a in t) if isinstance(t, tuple) \
                else t.to(dev)

        ops = [_PipeOps(self, {v: self._chunks[(s, v)] for v in range(V)},
                        to(xs, devs[0]) if s == 0 else None,
                        to(labs, devs[-1]) if s == S - 1 else None,
                        loss_fn, M, V - 1 if s == S - 1 else -1, scale)
               for s in range(S)]
        key = ("mpmd", mode, M, sig)
        driver = self._runners.get(key)
        primed = {}
        if driver is None:
            # the graph's boundary shape is chunk (0, 0)'s output: its
            # first forward, handed to the driver as that event's
            act_shape, act_dtype = (4, 16), "float32"
            if S * V > 1:
                primed[(0, 0, 0)] = x, y = stage_forward(ops[0], 0, 0)
                act_shape = tuple(y.shape)
                act_dtype = str(y.dtype).replace("torch.", "")
            driver = MpmdDriver(self._graph(mode, M, act_shape, act_dtype),
                                placements=devs)
            self._runners[key] = driver
        self.mpmd_driver = driver
        driver.programs = PipelinePrograms(driver.graph, ops, primed)
        driver.run()
        return torch.stack(ops[-1].losses).sum()

    # -- forward / eval ------------------------------------------------------
    def _forward_pipeline(self, data, compute_loss):
        M = self.accumulate_steps
        loss_fn = self._layers._loss_fn if compute_loss else None
        xs, labs, sig = self._prepare(data if compute_loss
                                      else (data[0], None), M)
        S, V = self._S, self.vpp_degree
        if self._mpmd:
            outs = []
            for m in range(M):
                x = xs[m] if not isinstance(xs, tuple) \
                    else tuple(a[m] for a in xs)
                for c in range(S * V):
                    s, v = c % S, c // S
                    if isinstance(x, torch.Tensor):
                        x = x.to(self._devices[s])
                    lab = None
                    if c == S * V - 1 and labs is not None:
                        lab = labs[m].to(self._devices[s])
                    x = self._run_chunk(self._chunks[(s, v)], x, lab, loss_fn)
                outs.append(_loss_value(x) / M if labs is not None else x)
            return torch.stack(outs).sum() if labs is not None \
                else merge_microbatches(torch.stack(outs))
        mode = "VPP" if V > 1 else "FThenB"
        runner = self._runner(mode, M, ("eval",) + sig)
        ops = _PipeOps(self, {v: self._chunks[(self._stage, v)]
                              for v in range(V)}, xs, labs, loss_fn, M,
                       V - 1 if self._stage == S - 1 else -1, None,
                       grad=False)
        with torch.no_grad():
            runner.run(ops, phases=("fwd",))
        if labs is not None:
            loss = torch.stack(ops.losses).sum() if ops.losses else \
                torch.zeros((), dtype=torch.float32,
                            device=self._model_device())
            return self._broadcast_loss(loss)
        if self._stage != S - 1:
            return None
        return merge_microbatches(torch.stack([ops.outs[m]
                                               for m in range(M)]))

    def forward(self, *inputs, **kwargs):
        """The model's output: the sequential run on a whole model (one
        stage, no MPMD), else the pipeline's forward (the output on the
        last stage, None on the others)."""
        if self._S == 1 and not self._mpmd:
            return self._layers(*inputs, **kwargs)
        x = inputs[0] if len(inputs) == 1 else tuple(inputs)
        return self._forward_pipeline((x, None), compute_loss=False)

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """The loss of ``data`` (every pp rank), or with ``compute_loss``
        False the output (on the last stage)."""
        if not compute_loss:
            return self.forward(data[0])
        return self._forward_pipeline(data, compute_loss=True)

    def sync_to_model(self):
        """The parameters are updated in place: nothing to write back."""

    def named_parameters(self, *a, **kw):
        return self._layers.named_parameters(*a, **kw)

    def parameters(self, *a, **kw):
        return self._layers.parameters(*a, **kw)

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)
