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

``shard_parameters_fsdp`` is ZeRO-3 (reference group_sharded_stage3.py):
each parameter whose dim 0 divides the group's size is held as this
rank's 1/n slice of dim 0 (the ``Parameter`` keeps its identity, its
``.data`` the slice), the rest stay whole. A forward pre-hook on each
module owning parameters all-gathers them (``_Gather``: in the compute
dtype when one is set, one all-gather a parameter) for that module's
forward alone; a saved-tensors hook keeps no gathered parameter for the
backward but a note, and gathers it again when the backward unpacks it
(the modules' backwards run in one order on every rank, so the
collectives pair). ``_Gather``'s backward reduce-scatters (mean) the
gradient onto the slice; a whole parameter's gradient is averaged over
the data group after the backward (``DistributedTrainStep``, or, in
eager code, the hook ``shard_parameters_fsdp`` registers). Between steps
a rank holds 1/n of every shardable parameter, of its gradient and of
its optimizer state. A model whose forward reads a submodule's
parameters without calling it (LLaMA's fused loss reads the head's
weight) names that submodule in ``zero3_entry_modules()``: its
parameters are gathered for the whole forward.

``SegmentParallel`` (sequence parallelism over ``sep``, reference
meta_parallel/segment_parallel.py:26; JAX :70-83) broadcasts the
parameters and buffers over dp x sharding x sep (and the unsliced ones
over mp) at wrap time; its forward keeps this rank's slice of dim 1 of
every tensor input of two or more dims (the ids, the labels), where the
JAX one constrains that dim over 'sep'. Its gradients are averaged over
dp x sharding x sep by ``HybridParallelOptimizer.step`` (eager code) or
``DistributedTrainStep`` (which splits the inputs itself and unwraps the
wrapper).
"""
from __future__ import annotations

import collections
import contextlib
import weakref

import torch

from ... import mesh as mesh_mod
from ...communication import collectives as C
from ...communication.group import _get_global_group
from .meta_parallel_base import (MetaParallelBase, check_sequence_split,
                                 torch_buffers, torch_params)


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
            _broadcast_all(_unsliced(self._layers,
                                     [t for _, t, d in params if not d]),
                           hcg.get_model_parallel_group())
            _broadcast_all(_unsliced(self._layers, [t for _, t, _ in params])
                           + torch_buffers(self._layers),
                           hcg.get_dp_sharding_group())


class ShardingParallel(MetaParallelBase):
    def _prepare_for_model(self):
        hcg = self._hcg or mesh_mod.get_hybrid_communicate_group()
        with torch.no_grad():
            _broadcast_all(_unsliced(self._layers, [
                t for _, t, _ in torch_params(self._layers)])
                + torch_buffers(self._layers), hcg.get_dp_sharding_group())


class SegmentParallel(MetaParallelBase):
    def _prepare_for_model(self):
        hcg = self._hcg or mesh_mod.get_hybrid_communicate_group()
        self._sep = hcg.get_sep_parallel_group()
        if self._sep.nranks > 1:
            check_sequence_split(self._layers, self._sep)
        params = torch_params(self._layers)
        with torch.no_grad():
            _broadcast_all(_unsliced(self._layers,
                                     [t for _, t, d in params if not d]),
                           hcg.get_model_parallel_group())
            _broadcast_all(_unsliced(self._layers, [t for _, t, _ in params])
                           + torch_buffers(self._layers),
                           hcg.get_data_sep_group())

    def forward(self, *inputs, **kwargs):
        return self._layers(*(self._chunk(x) for x in inputs),
                            **{k: self._chunk(v) for k, v in kwargs.items()})

    def _chunk(self, x):
        """This sep rank's slice of dim 1 of a tensor of 2+ dims."""
        g = self._sep
        data = getattr(x, "_data", x)
        if g.nranks == 1 or not isinstance(data, torch.Tensor) \
                or data.dim() < 2:
            return x
        n = data.shape[1]
        if n % g.nranks:
            raise ValueError(f"the sequence dim ({n}) must be divisible by "
                             f"the sep degree ({g.nranks})")
        k = n // g.nranks
        part = data.narrow(1, g.rank * k, k)
        if x is data:
            return part
        from ....core.tensor import Tensor
        return Tensor._from_data(part)


class _Gather(torch.autograd.Function):
    """A parameter's slice -> the whole parameter (all-gather over the
    ZeRO group, in ``dtype``); the gradient reduce-scattered (mean)
    back onto the slice, in f32."""

    @staticmethod
    def forward(ctx, shard, z, idx, dtype):
        ctx.z, ctx.idx, ctx.dtype = z, idx, shard.dtype
        return z.gather(idx, dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.z.scatter_grad(ctx.idx, g).to(ctx.dtype), None, None, None


class Zero3:
    """The ZeRO-3 state of a model: its parameters sliced over
    ``group`` (``dp_group``: the rest of the data group, over which the
    slices' gradients are also averaged), the hooks that gather them."""

    #: gathered parameters the backward keeps at once (a layer's); the
    #: cache lives for one backward: emptied when it ends and when a
    #: forward starts, so no step reads a gather of older weights
    CACHE = 8

    def __init__(self, model, group, dp_group=None):
        self.group = group
        self.dp_group = dp_group if dp_group is not None and \
            dp_group.nranks > 1 else None
        self.n, self.rank = group.nranks, group.rank
        self.amp = None
        self.entries = []         # [module, name, Parameter, full shape]
        self.whole = []           # (name, Parameter) not sliced
        self._hooks = []
        self._live = {}           # storage ptr -> entry index (forward)
        self._cache = collections.OrderedDict()
        names = {id(p): n for n, p in model.named_parameters()}
        done = set()
        with torch.no_grad():
            for mod in model.modules():
                own = [(k, p) for k, p in mod._parameters.items()
                       if p is not None and id(p) not in done]
                for k, p in own:
                    done.add(id(p))
                    if self.n > 1:
                        C.broadcast(p, src=group.ranks[0], group=group)
                    if p.dim() >= 1 and p.shape[0] % self.n == 0 \
                            and self.n > 1:
                        full = tuple(p.shape)
                        kk = p.shape[0] // self.n
                        p.data = p.data[self.rank * kk:
                                        (self.rank + 1) * kk].clone()
                        self.entries.append([mod, k, p, full,
                                             names.get(id(p), k)])
                    else:
                        self.whole.append((names.get(id(p), k), p))
                if own:
                    self._hooks.append(mod.register_forward_pre_hook(
                        self._pre))
                    self._hooks.append(mod.register_forward_hook(
                        self._post))
        self._by_mod = collections.defaultdict(list)
        for i, e in enumerate(self.entries):
            self._by_mod[id(e[0])].append(i)
        self._whole_by_mod = collections.defaultdict(list)
        for mod in model.modules():
            for k, p in mod._parameters.items():
                if p is not None and any(p is w for _, w in self.whole):
                    self._whole_by_mod[id(mod)].append(k)
        # modules whose parameters the model's own forward reads without
        # calling them (a fused loss reading the head's weight): gathered
        # for the whole forward
        entry = getattr(model, "zero3_entry_modules", None)
        self._entry = list(entry()) if entry is not None else []
        self._hooks.append(model.register_forward_pre_hook(self._enter))
        self._hooks.append(model.register_forward_hook(self._exit))
        self._saving = None
        self._saved = {}
        for _, p in self.whole:
            if self._data_group_size() > 1 and p.requires_grad:
                p.register_post_accumulate_grad_hook(self._avg_whole)

    # -- collectives ---------------------------------------------------------
    def _data_group_size(self):
        return self.n * (self.dp_group.nranks if self.dp_group else 1)

    def gather(self, idx, dtype=None):
        mod, k, p, full, _ = self.entries[idx]
        src = p.detach()
        if dtype is not None and src.is_floating_point():
            src = src.to(dtype)
        out = torch.empty(full, dtype=src.dtype, device=src.device)
        C.all_gather(list(out.chunk(self.n)), src.contiguous(),
                     group=self.group)
        return out

    def scatter_grad(self, idx, g):
        g = g.float().contiguous()
        out = torch.empty((g.shape[0] // self.n,) + tuple(g.shape[1:]),
                          dtype=torch.float32, device=g.device)
        C.reduce_scatter(out, g, op=C.ReduceOp.AVG, group=self.group)
        if self.dp_group is not None:
            C.all_reduce(out, op=C.ReduceOp.AVG, group=self.dp_group)
        return out

    def _avg_whole(self, p):
        if p.grad is not None:
            self.reduce_whole([p.grad])

    @torch.no_grad()
    def reduce_whole(self, grads):
        """Average whole parameters' gradients over the data group."""
        if self._data_group_size() <= 1 or not grads:
            return grads
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        C.all_reduce(flat, op=C.ReduceOp.AVG, group=self.group)
        if self.dp_group is not None:
            C.all_reduce(flat, op=C.ReduceOp.AVG, group=self.dp_group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return grads

    # -- the hooks -----------------------------------------------------------
    def _pre(self, mod, args):
        if id(mod) in self._saved:       # gathered at the model's entry
            return
        self._saved[id(mod)] = {}
        for i in self._by_mod.get(id(mod), ()):
            _, k, p, _, _ = self.entries[i]
            full = _Gather.apply(p, self, i, self.amp)
            self._saved[id(mod)][k] = p
            mod._parameters[k] = full
            # a dead tensor's storage can be reused: keep a weak ref
            self._live[full.untyped_storage().data_ptr()] = (
                i, weakref.ref(full))
        if self.amp is not None:
            for k in self._whole_by_mod.get(id(mod), ()):
                p = mod._parameters[k]
                if p.is_floating_point():
                    self._saved[id(mod)][k] = p
                    mod._parameters[k] = p.to(self.amp)

    def _post(self, mod, args, out):
        if any(mod is m for m in self._entry):
            return None
        for k, p in self._saved.pop(id(mod), {}).items():
            mod._parameters[k] = p
        return None

    def _enter(self, mod, args):
        self._cache.clear()
        if self._saving is None and torch.is_grad_enabled():
            self._live = {}
            self._saving = torch.autograd.graph.saved_tensors_hooks(
                self._pack, self._unpack)
            self._saving.__enter__()
        for m in self._entry:
            self._pre(m, ())

    def _exit(self, mod, args, out):
        for m in self._entry:
            for k, p in self._saved.pop(id(m), {}).items():
                m._parameters[k] = p
        if self._saving is not None:
            self._saving.__exit__(None, None, None)
            self._saving = None
            self._live = {}
        return None

    def _pack(self, t):
        hit = self._live.get(t.untyped_storage().data_ptr())
        if hit is None or hit[1]() is None or \
                hit[1]().untyped_storage().data_ptr() != \
                t.untyped_storage().data_ptr():
            return t
        return ("zero3", hit[0], tuple(t.shape), tuple(t.stride()),
                t.storage_offset(), t.dtype)

    def _unpack(self, obj):
        if not (isinstance(obj, tuple) and obj and obj[0] == "zero3"):
            return obj
        _, i, shape, stride, off, dtype = obj
        full = self._cache.get((i, dtype))
        if full is None:
            with torch.no_grad():
                full = self.gather(i, dtype)
            if not self._cache:
                torch.autograd.Variable._execution_engine.queue_callback(
                    self._cache.clear)
            self._cache[(i, dtype)] = full
            while len(self._cache) > self.CACHE:
                self._cache.popitem(last=False)
        return full.as_strided(shape, stride, off)

    def clip_scale(self, clip, parts, mp_group=None):
        """The global-norm clip's factor of a ZeRO-3 gradient: ``parts``
        (grad, is_distributed, is_whole); the slices' squares summed over
        the data group, a whole parameter's counted once, the mp-sharded
        ones' summed over ``mp_group``. None for another clip."""
        from ....nn.clip import ClipGradByGlobalNorm
        if not isinstance(clip, ClipGradByGlobalNorm):
            return None
        dev = parts[0][0].device
        sq = torch.zeros(4, dtype=torch.float32, device=dev)
        for g, dist, whole in parts:
            if g is not None:
                sq[(0 if dist else 1) + (2 if whole else 0)] += \
                    torch.sum(torch.square(g.float()))
        sliced = sq[:2].clone()
        C.all_reduce(sliced, group=self.group)
        if self.dp_group is not None:
            C.all_reduce(sliced, group=self.dp_group)
        dist_sq = (sliced[0] + sq[2]).reshape(1)
        if mp_group is not None and mp_group.nranks > 1:
            C.all_reduce(dist_sq, group=mp_group)
        gn = torch.sqrt(dist_sq[0] + sliced[1] + sq[3])
        return clip.clip_norm / torch.clamp(gn, min=clip.clip_norm)

    def is_whole(self, p) -> bool:
        return any(p is w for _, w in self.whole)

    # -- accounting ----------------------------------------------------------
    def resident_bytes(self) -> dict:
        """Bytes of parameters this rank holds: the slices and the whole
        (unshardable) ones."""
        sl = sum(e[2].numel() * e[2].element_size() for e in self.entries)
        wh = sum(p.numel() * p.element_size() for _, p in self.whole)
        return {"sliced": sl, "whole": wh, "total": sl + wh}

    @torch.no_grad()
    def full_parameters(self) -> dict:
        """{name: the whole parameter} (every sliced one all-gathered:
        every rank of the group must call it)."""
        out = {name: p.detach().clone() for name, p in self.whole}
        for i, e in enumerate(self.entries):
            out[e[4]] = self.gather(i)
        return out


def shard_parameters_fsdp(layer, axis="sharding"):
    """ZeRO-3: slice ``layer``'s parameters over the mesh group of
    ``axis`` (an axis name or a tuple of axes; "sharding" also averages
    the gradients over "dp" when dp > 1) and gather them layer by layer
    (``Zero3``). A group of one leaves the layer as it is."""
    hcg = mesh_mod.get_hybrid_communicate_group()
    mesh = mesh_mod.ensure_mesh()
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    group = mesh.group(axes)
    dp_group = None
    if "dp" not in axes and mesh_mod.axis_degree("dp") > 1:
        dp_group = hcg.get_data_parallel_group()
    if not isinstance(layer, torch.nn.Module):
        raise NotImplementedError(
            "ZeRO-3 shards a torch.nn.Module's parameters; a surface "
            "Layer's is not ported")
    if group.nranks <= 1 or zero3_of(layer) is not None:
        return layer
    z = Zero3(layer, group, dp_group)
    layer.__dict__["_zero3"] = z
    for p in layer.parameters():
        p.__dict__["_zero3"] = z
    return layer


def zero3_of(model):
    """The ``Zero3`` state of a (wrapped) model, or None."""
    inner = getattr(model, "_layers", model) if isinstance(
        model, MetaParallelBase) else model
    return inner.__dict__.get("_zero3") if hasattr(inner, "__dict__") \
        else None


def _unsliced(model, tensors):
    """``tensors`` without ZeRO-3 slices (which differ by rank)."""
    z = zero3_of(model)
    if z is None:
        return tensors
    sliced = {id(e[2]) for e in z.entries}
    return [t for t in tensors if id(t) not in sliced]
