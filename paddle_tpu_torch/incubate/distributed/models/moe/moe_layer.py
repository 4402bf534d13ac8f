"""MoELayer — mixture of experts (counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``).

Experts are stacked parameters [E, ...] (``GroupedExpertsFFN``). Three
dispatch modes, with identical routing decisions:

- ``"pallas"`` (the default; the name kept for API parity): sparse routing
  indices, tokens and their combine weights scattered into a per-expert
  capacity buffer, then the fused grouped-FFN kernels
  (``kernels.moe.grouped_ffn``: the CUDA kernels on the GPU, their plain
  versions on the CPU), whose epilogue applies the combine weight, so the
  combine is a gather and a sum;
- ``"scatter"``: the same sparse routing, ``index_add`` dispatch, the
  experts' plain forward, a weighted gather combine;
- ``"einsum"``: dense one-hot dispatch/combine with GShard group-wise
  routing (``group_size``), in plain PyTorch as XLA computes it in JAX.

The dispatch scatter, trash slot, counts and combine gather are plain
``index_add`` / indexing with autograd. ``self.l_aux`` holds the
load-balancing loss after every forward. A fallback from the kernel path
keeps only the semantic reasons of the JAX ladder (:309): custom experts
and an activation the kernels do not compute — counted on
``kernels.moe.dispatch_path.fallback.<reason>`` (forward, which then runs
the einsum dispatch, as in JAX) and ``kernels.moe.decode_path.fallback.
<reason>`` (serving decode mode, the scatter dispatch). The geometry,
platform and Mosaic-probe reasons are TPU constraints and do not exist
here.

Expert parallelism (``moe_group``, or the mesh's ``ep`` axis, of n > 1
ranks): ``GroupedExpertsFFN`` holds this rank's E / n experts, rows
[r E / n, (r + 1) E / n) of the stacked [E, ...] parameters (drawn at
their global shape and sliced, marked ``expert_parallel``). The JAX
package shards the experts over 'ep' and lets GSPMD move the tokens;
the port reproduces its semantics exactly:

- routing is global: the capacity comes from the global token count and
  the positions run over every token in batch order. Tokens are split
  over dp x sharding only (``mesh.data_axes``) and replicated over ep;
  with a data group of D > 1 ranks, the [N / D, E] gate logits are
  all-gathered over it (the backward reduce-scatters: the aux loss reads
  every row on every rank), routed as one device routes them, and this
  rank keeps its rows of the dispatch and combine;
- the kernel dispatch falls back to the einsum one over an ep group
  (``kernels.moe.dispatch_path.fallback.ep-sharded``, JAX :321-327;
  decode mode to the scatter one). The einsum and scatter dispatches
  build this rank's tokens' part of ``expert_in`` [E, C, h], all-reduce
  it over the data group (backward: all-reduce), keep this rank's E / n
  rows (backward: all-gather over ep), run the local experts, all-gather
  their outputs over ep (backward: this rank's rows) and combine this
  rank's tokens. An all-to-all is later work.

An MoE layer built on a mesh that splits the sequence over ``sep``
raises (the tokens' global order would span the sep ranks).

Counters, bumped per call (the port runs eagerly, there is no trace):
``kernels.moe.dispatch_path.{pallas,scatter,einsum}`` and
``kernels.moe.decode_path.pallas``.
"""
from __future__ import annotations

import functools
import logging
from typing import Optional

import torch
from torch import nn

from ..... import monitor
from .....core.device import resolve_device
from .....distributed import mesh as mesh_mod
from .....distributed.communication import collectives as C
from .....distributed.fleet.layers.mpu import mp_ops
from .....kernels import moe as moe_kernels
from .gate import (BaseGate, GShardGate, NaiveGate, SwitchGate,
                   apply_router_jitter, topk_gating, topk_gating_sparse)

_logger = logging.getLogger(__name__)
_fallback_logged = set()


def _act(h, activation):
    if activation == "gelu":
        return torch.nn.functional.gelu(h, approximate="tanh")
    return torch.clamp_min(h, 0)


class GroupedExpertsFFN(nn.Module):
    """E parallel FFN experts as stacked weights w1 [E, h, dff], b1
    [E, 1, dff], w2 [E, dff, h], b2 [E, 1, h] (the JAX layout). With an
    expert-parallel group of n > 1 ranks (``ep_group``) this rank holds
    its E / n rows of each (``num_local_experts``), marked
    ``expert_parallel``; ``shard(full)`` slices a global tensor to them."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 activation="gelu", device=None, dtype=None, ep_group=None):
        super().__init__()
        self.num_experts = num_experts
        self.ep_group = ep_group if ep_group is not None and \
            ep_group.nranks > 1 else None
        n = 1 if self.ep_group is None else self.ep_group.nranks
        if num_experts % n:
            raise ValueError(f"num_experts ({num_experts}) must be divisible "
                             f"by the expert-parallel degree ({n})")
        self.ep_rank = 0 if self.ep_group is None else self.ep_group.rank
        self.ep_degree = n
        self.num_local_experts = e = num_experts // n

        def p(*shape):
            t = nn.Parameter(torch.zeros(shape, device=device, dtype=dtype))
            t.expert_parallel = n > 1
            return t
        self.w1 = p(e, d_model, d_hidden)
        self.b1 = p(e, 1, d_hidden)
        self.w2 = p(e, d_hidden, d_model)
        self.b2 = p(e, 1, d_model)
        self._act = activation

    def shard(self, full):
        """This rank's rows of a global [E, ...] tensor."""
        e = self.num_local_experts
        return full[self.ep_rank * e:(self.ep_rank + 1) * e]

    def global_shape(self, name):
        return (self.num_experts,) + tuple(getattr(self, name).shape[1:])

    def forward(self, x):
        """x [E, C, h] -> [E, C, h] (batched per-expert products)."""
        h = torch.einsum("ech,ehf->ecf", x, self.w1) + self.b1
        return torch.einsum("ecf,efh->ech", _act(h, self._act),
                            self.w2) + self.b2


@functools.lru_cache(maxsize=None)
def _n_groups_cached(n, gs):
    """Largest divisor of n giving groups of >= gs tokens; warns once per
    (n, gs) when the search collapses toward one group (counted on
    ``lint.moe-group-degraded``)."""
    if not gs or n <= gs:
        return 1
    g = max(1, n // int(gs))
    while n % g:
        g -= 1
    if n // g > 2 * int(gs):
        monitor.counter("lint.moe-group-degraded").increase()
        _logger.warning(
            "MoE group-wise dispatch: %d tokens has no divisor near "
            "group_size=%d (using %d groups of %d); pad batch*seq to a "
            "rounder number to keep dispatch cost linear", n, gs, g, n // g)
    return g


def moe_dispatch_einsum(tok, d):
    """Dense one-hot dispatch: [N, h] x [N, E, C] (or grouped [G, n, E, C])
    -> [E, C(*G), h]."""
    h = tok.shape[-1]
    if d.dim() == 3:
        return torch.einsum("nh,nec->ech", tok, d)
    g, gn, e, c = d.shape
    ei = torch.einsum("gnh,gnec->gech", tok.reshape(g, gn, h), d)
    return ei.transpose(0, 1).reshape(e, g * c, h)


def moe_combine_einsum(eo, c):
    """The mirrored dense combine."""
    h = eo.shape[-1]
    if c.dim() == 3:
        return torch.einsum("ech,nec->nh", eo, c)
    g, gn, e, cc = c.shape
    eg = eo.reshape(e, g, cc, h).transpose(0, 1)
    return torch.einsum("gech,gnec->gnh", eg, c).reshape(g * gn, h)


class _SumOverData(torch.autograd.Function):
    """The data ranks' parts of an expert buffer summed (their token slots
    are disjoint); the backward sums the ranks' gradients likewise."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        C.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        C.all_reduce(out, group=ctx.group)
        return out, None


class _EpSlice(mp_ops._Split):
    """This rank's experts' rows of [E, C, h]; the backward all-gathers
    over ep."""


class _EpGather(mp_ops._Concat):
    """The ep ranks' expert outputs gathered to [E, C, h]; the backward
    keeps this rank's rows (every ep rank holds the whole gradient: the
    tokens are replicated over ep)."""


def _slots(idx, pos, keep, cap, trash):
    """Flat buffer slot of every (round, token): expert * cap + position,
    or ``trash`` where the assignment was not kept."""
    return torch.where(keep, idx.long() * cap + pos.long(),
                       torch.full_like(pos, trash, dtype=torch.long))


class MoELayer(nn.Module):
    """Mixture of experts. Args as the JAX ``MoELayer``: d_model, d_hidden,
    num_experts, gate ("gshard" | "switch" | "naive" | a BaseGate),
    top_k / capacity_factor, experts (a custom module [E, C, h] ->
    [E, C, h]), group_size (GShard group-wise dispatch of the einsum
    mode), dispatch_mode ("pallas" | "einsum" | "scatter"). ``moe_group``
    (a ``Group``) or the mesh's ``ep_axis`` of n > 1 ranks: expert
    parallelism, this rank holding E / n experts (module docstring);
    ``name`` is accepted for API parity and unused.

    ``device=None`` builds it on ``cuda``; ``device="cpu"`` on the CPU.
    Weights are drawn from ``seed`` (normal, std 0.02; biases 0).
    ``generator`` feeds the router jitter of a jittered gate in training
    (the global generator when None)."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 gate="gshard", top_k: Optional[int] = None,
                 capacity_factor: Optional[float] = None,
                 experts: Optional[nn.Module] = None, moe_group=None,
                 ep_axis: str = "ep", group_size: Optional[int] = None,
                 dispatch_mode: str = "pallas", name=None, device=None,
                 dtype=None, seed: int = 0, generator=None):
        super().__init__()
        if dispatch_mode not in ("pallas", "einsum", "scatter"):
            raise ValueError(
                f"dispatch_mode must be 'pallas', 'einsum' or 'scatter', "
                f"got {dispatch_mode!r}")
        if mesh_mod.get_mesh() is not None and \
                mesh_mod.axis_degree("sep") > 1:
            raise NotImplementedError(
                "an MoE layer on a mesh that splits the sequence over sep: "
                "global routing across the sep ranks' tokens is not "
                "carried")
        device = resolve_device(device)
        self._ep, self._tok = _expert_groups(moe_group, ep_axis)
        if self._ep is not None and num_experts % self._ep.nranks:
            raise ValueError(
                f"num_experts ({num_experts}) must be divisible by the "
                f"expert-parallel degree ({self._ep.nranks})")
        self.d_model = d_model
        self.num_experts = num_experts
        self._group_size = group_size
        self._dispatch_mode = dispatch_mode
        self.generator = generator
        self.gate_weight = nn.Parameter(torch.zeros(
            (d_model, num_experts), device=device, dtype=dtype))
        if isinstance(gate, BaseGate):
            self.gate = gate
        elif gate == "switch":
            self.gate = SwitchGate(num_experts, capacity_factor or 1.25)
        elif gate == "naive":
            self.gate = NaiveGate(num_experts, top_k or 2,
                                  capacity_factor or 1.25)
        elif gate == "gshard":
            self.gate = GShardGate(num_experts, capacity_factor or 2.0)
        else:
            raise ValueError(
                f"unknown gate {gate!r}: expected 'gshard', 'switch', "
                "'naive', or a BaseGate instance")
        if top_k is not None:
            self.gate.top_k = top_k
        own = [self.gate_weight]
        if experts is None:
            experts = GroupedExpertsFFN(num_experts, d_model, d_hidden,
                                        device=device, dtype=dtype,
                                        ep_group=self._ep)
            own += [experts.w1, experts.w2]
        self.experts = experts
        self.l_aux = None
        gen = torch.Generator(device=device).manual_seed(int(seed))
        with torch.no_grad():
            for p in own:
                if p is self.gate_weight or self._ep is None:
                    p.normal_(0.0, 0.02, generator=gen)
                else:
                    # drawn at the global shape: any ep degree builds the
                    # same global layer from one seed
                    full = torch.empty((num_experts,) + tuple(p.shape[1:]),
                                       device=p.device, dtype=p.dtype)
                    p.copy_(experts.shard(full.normal_(0.0, 0.02,
                                                       generator=gen)))

    def _jitter(self):
        jitter = getattr(self.gate, "jitter", 0.0)
        return jitter if (jitter and self.training) else 0.0

    def _sparse_route(self, tokens, cap, token_mask):
        """The one sparse routing call the scatter and kernel dispatches
        share: (idx, pos, keep, w); sets ``l_aux``."""
        mask = token_mask
        if self._tok is not None and mask is not None:
            mask = C.all_gather(None, mask.contiguous(), group=self._tok)
            mask = torch.cat(mask)
        idx, pos, keep, w, aux = topk_gating_sparse(
            self._global_logits(tokens), self.gate.top_k, cap,
            train=self.training, generator=self.generator,
            switch_jitter=self._jitter(), token_mask=mask)
        self.l_aux = aux
        return tuple(self._rows(t, 1) for t in (idx, pos, keep, w))

    # -- expert parallelism (module docstring) ------------------------------
    def _global_logits(self, tokens):
        """The router logits of every token of the data group, in batch
        order (this rank's when the tokens are not split)."""
        logits = tokens @ self.gate_weight
        if self._tok is None:
            return logits
        return mp_ops._AllGatherRS.apply(logits, self._tok, 0)

    def _n_global(self, n):
        """The data group's token count (the capacity's)."""
        return int(n) * (1 if self._tok is None else self._tok.nranks)

    def _rows(self, t, dim):
        """This data rank's token rows of a global routing tensor."""
        if self._tok is None:
            return t
        k = t.shape[dim] // self._tok.nranks
        return t.narrow(dim, self._tok.rank * k, k)

    def _global_tokens(self, tokens):
        """[N, h]: this rank's tokens in its rows of the data group's
        batch, zeros elsewhere (its part of a dispatch)."""
        if self._tok is None:
            return tokens
        n, r = self._tok.nranks, self._tok.rank
        pad = [tokens.new_zeros(tokens.shape) for _ in range(n)]
        return torch.cat(pad[:r] + [tokens] + pad[r + 1:])

    def _run_experts(self, expert_in):
        """``expert_in`` [E, C, h] (this rank's tokens' part) -> the
        experts' output [E, C, h]: summed over the data group, this
        rank's experts run, their outputs gathered over ep."""
        if self._tok is not None:
            expert_in = _SumOverData.apply(expert_in, self._tok)
        if self._ep is None:
            return self.experts(expert_in)
        local = self.experts(_EpSlice.apply(expert_in, self._ep, 0))
        return _EpGather.apply(local, self._ep, 0)

    def _forward_scatter(self, tokens, orig_shape, token_mask=None,
                         cap=None):
        """Sparse dispatch: index_add into the flat [E * C, h] buffer (a
        trash slot takes the dropped tokens), the experts' forward, a
        weighted gather back."""
        n, h = tokens.shape
        e = self.num_experts
        if cap is None:
            cap = self.gate.capacity(self._n_global(n))
        idx, pos, keep, w = self._sparse_route(tokens, cap, token_mask)
        dst = _slots(idx, pos, keep, cap, e * cap)
        buf = tokens.new_zeros((e * cap + 1, h))
        for r in range(idx.shape[0]):
            buf = buf.index_add(0, dst[r], tokens)
        expert_out = self._run_experts(buf[:e * cap].reshape(e, cap, h))
        flat = expert_out.reshape(e * cap, h)
        src = _slots(idx, pos, keep, cap, 0)
        out = 0.0
        for r in range(idx.shape[0]):
            out = out + flat[src[r]] * (w[r] * keep[r])[:, None]
        return out.to(expert_out.dtype).reshape(orig_shape)

    def _pallas_fallback_reason(self):
        """None when the grouped-FFN kernels can serve this layer; else the
        reason (the ``...fallback.<reason>`` counter suffix)."""
        if not isinstance(self.experts, GroupedExpertsFFN):
            return "custom-experts"
        if self.experts._act not in ("gelu", "relu"):
            return "activation"
        if self._ep is not None:
            # as in JAX: the kernels take a rank's whole expert buffer, so
            # an expert-parallel layer keeps the einsum dispatch
            return "ep-sharded"
        return None

    def _forward_pallas(self, tokens, orig_shape, token_mask=None, cap=None):
        """Kernel dispatch: the sparse routing, tokens and combine weights
        scattered into a [E, cap_pad, h] buffer (``padded_capacity``, the
        JAX layout), the grouped FFN over the live rows (counts from
        ``keep``), and a gather plus sum back — the combine weights were
        applied in the kernel's epilogue."""
        n, h = tokens.shape
        e = self.num_experts
        if cap is None:
            cap = self.gate.capacity(self._n_global(n))
        cap_pad = moe_kernels.padded_capacity(cap, tokens.dtype)
        idx, pos, keep, w = self._sparse_route(tokens, cap, token_mask)
        dst = _slots(idx, pos, keep, cap_pad, e * cap_pad)
        buf = tokens.new_zeros((e * cap_pad + 1, h))
        wbuf = tokens.new_zeros((e * cap_pad + 1, 1), dtype=torch.float32)
        for r in range(idx.shape[0]):
            buf = buf.index_add(0, dst[r], tokens)
            wbuf = wbuf.index_add(0, dst[r],
                                  (w[r] * keep[r]).float()[:, None])
        # kept assignments per expert: the kernels' liveness prefix
        owner = torch.where(keep, idx.long(),
                            torch.full_like(idx, e, dtype=torch.long))
        counts = torch.zeros(e + 1, dtype=torch.int32,
                             device=tokens.device).index_add(
            0, owner.reshape(-1), keep.reshape(-1).to(torch.int32))[:e]
        if self._tok is not None:
            # every data rank's tokens: the buffers' parts summed
            buf = _SumOverData.apply(buf, self._tok)
            wbuf = _SumOverData.apply(wbuf, self._tok)
            C.all_reduce(counts, group=self._tok)
        ex = self.experts
        expert_out = moe_kernels.grouped_ffn(
            buf[:e * cap_pad].reshape(e, cap_pad, h), ex.w1, ex.b1, ex.w2,
            ex.b2, wbuf[:e * cap_pad].reshape(e, cap_pad, 1), counts,
            activation=ex._act)
        flat = expert_out.reshape(e * cap_pad, h)
        src = _slots(idx, pos, keep, cap_pad, 0)
        out = 0.0
        for r in range(idx.shape[0]):
            out = out + flat[src[r]] * keep[r].to(flat.dtype)[:, None]
        return out.to(expert_out.dtype).reshape(orig_shape)

    def _fallback(self, path, reason):
        monitor.counter(f"kernels.moe.{path}.fallback.{reason}").increase()
        key = (path, reason)
        if key not in _fallback_logged:
            _fallback_logged.add(key)
            _logger.info("MoE %s leaves the grouped-FFN kernels: %s", path,
                         reason)

    def _forward_decode(self, tokens, orig_shape, token_mask):
        """Serving decode mode: no capacity drops (capacity = the tick's
        token count) and dead lanes (``token_mask`` False) routed nowhere:
        they claim no buffer slot, and the kernels' live counts skip them.
        The kernel dispatch, or the sparse scatter when the layer falls
        back; never the dense einsum."""
        n = self._n_global(tokens.shape[0])
        mask = None if token_mask is None else \
            token_mask.reshape(-1).to(torch.bool)
        reason = self._pallas_fallback_reason()
        if reason is None:
            monitor.counter("kernels.moe.decode_path.pallas").increase()
            return self._forward_pallas(tokens, orig_shape, token_mask=mask,
                                        cap=n)
        self._fallback("decode_path", reason)
        return self._forward_scatter(tokens, orig_shape, token_mask=mask,
                                     cap=n)

    def forward(self, x, token_mask=None, decode_mode=False):
        """x [batch, seq, h] or [N, h]. ``decode_mode=True``: the serving
        engine's cached forward (see ``_forward_decode``)."""
        orig_shape = x.shape
        h = orig_shape[-1]
        tokens = x.reshape(-1, h)
        if decode_mode:
            return self._forward_decode(tokens, orig_shape, token_mask)
        mode = self._dispatch_mode
        if mode == "pallas":
            reason = self._pallas_fallback_reason()
            if reason is None:
                monitor.counter("kernels.moe.dispatch_path.pallas").increase()
                return self._forward_pallas(tokens, orig_shape)
            self._fallback("dispatch_path", reason)
            mode = "einsum"
        if mode == "scatter":
            monitor.counter("kernels.moe.dispatch_path.scatter").increase()
            return self._forward_scatter(tokens, orig_shape)
        monitor.counter("kernels.moe.dispatch_path.einsum").increase()
        return self._forward_einsum(tokens, orig_shape)

    def _forward_einsum(self, tokens, orig_shape):
        logits = self._global_logits(tokens)
        n = int(logits.shape[0])
        e = self.num_experts
        top_k = self.gate.top_k
        ng = _n_groups_cached(n, self._group_size)
        cap = self.gate.capacity(n // ng)
        if ng == 1:
            dispatch, combine, aux = topk_gating(
                logits, top_k, cap, train=self.training,
                generator=self.generator, switch_jitter=self._jitter())
        else:
            # jitter once over all tokens, then route each group with its
            # own capacity (aux = the groups' mean)
            logits = apply_router_jitter(logits, self._jitter(),
                                         self.training, self.generator)
            routed = [topk_gating(lg, top_k, cap, train=self.training)
                      for lg in logits.reshape(ng, n // ng, e)]
            dispatch = torch.stack([r[0] for r in routed])
            combine = torch.stack([r[1] for r in routed])
            aux = torch.stack([r[2] for r in routed]).mean()
        self.l_aux = aux
        expert_out = self._run_experts(moe_dispatch_einsum(
            self._global_tokens(tokens), dispatch))
        out = moe_combine_einsum(expert_out, combine)
        return self._rows(out, 0).reshape(orig_shape)


def _expert_groups(moe_group, ep_axis):
    """(the ep group, the data group the tokens are split over), each
    None when trivial: ``moe_group`` or the mesh's ``ep_axis``; the
    mesh's dp x sharding."""
    mesh = mesh_mod.get_mesh()
    ep = moe_group
    if ep is None and mesh is not None and ep_axis in mesh.axis_names \
            and mesh.shape[ep_axis] > 1:
        ep = mesh.group(ep_axis)
    if ep is not None and ep.nranks <= 1:
        ep = None
    tok = None
    if mesh is not None and mesh.shape.get("dp", 1) * \
            mesh.shape.get("sharding", 1) > 1:
        tok = mesh.group(("dp", "sharding"))
    return ep, tok


__all__ = ["GroupedExpertsFFN", "MoELayer", "NaiveGate", "SwitchGate",
           "GShardGate"]
