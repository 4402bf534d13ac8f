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
here. Expert parallelism (``moe_group``) comes with the distributed slice.

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
    [E, 1, dff], w2 [E, dff, h], b2 [E, 1, h] (the JAX layout)."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 activation="gelu", device=None, dtype=None):
        super().__init__()
        self.num_experts = num_experts

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device,
                                            dtype=dtype))
        self.w1 = p(num_experts, d_model, d_hidden)
        self.b1 = p(num_experts, 1, d_hidden)
        self.w2 = p(num_experts, d_hidden, d_model)
        self.b2 = p(num_experts, 1, d_model)
        self._act = activation

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
    (expert parallelism) raises NotImplementedError; ``ep_axis`` and
    ``name`` are accepted for API parity and unused.

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
        if moe_group is not None:
            raise NotImplementedError(
                "expert parallelism (moe_group, the 'ep' mesh axis) comes "
                "with the distributed slice of the port")
        device = resolve_device(device)
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
                                        device=device, dtype=dtype)
            own += [experts.w1, experts.w2]
        self.experts = experts
        self.l_aux = None
        gen = torch.Generator(device=device).manual_seed(int(seed))
        with torch.no_grad():
            for p in own:
                p.normal_(0.0, 0.02, generator=gen)

    def _jitter(self):
        jitter = getattr(self.gate, "jitter", 0.0)
        return jitter if (jitter and self.training) else 0.0

    def _sparse_route(self, tokens, cap, token_mask):
        """The one sparse routing call the scatter and kernel dispatches
        share: (idx, pos, keep, w); sets ``l_aux``."""
        idx, pos, keep, w, aux = topk_gating_sparse(
            tokens @ self.gate_weight, self.gate.top_k, cap,
            train=self.training, generator=self.generator,
            switch_jitter=self._jitter(), token_mask=token_mask)
        self.l_aux = aux
        return idx, pos, keep, w

    def _forward_scatter(self, tokens, orig_shape, token_mask=None,
                         cap=None):
        """Sparse dispatch: index_add into the flat [E * C, h] buffer (a
        trash slot takes the dropped tokens), the experts' forward, a
        weighted gather back."""
        n, h = tokens.shape
        e = self.num_experts
        if cap is None:
            cap = self.gate.capacity(int(n))
        idx, pos, keep, w = self._sparse_route(tokens, cap, token_mask)
        dst = _slots(idx, pos, keep, cap, e * cap)
        buf = tokens.new_zeros((e * cap + 1, h))
        for r in range(idx.shape[0]):
            buf = buf.index_add(0, dst[r], tokens)
        expert_out = self.experts(buf[:e * cap].reshape(e, cap, h))
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
            cap = self.gate.capacity(int(n))
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
        n = int(tokens.shape[0])
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
        n = int(tokens.shape[0])
        e = self.num_experts
        top_k = self.gate.top_k
        ng = _n_groups_cached(n, self._group_size)
        cap = self.gate.capacity(n // ng)
        logits = tokens @ self.gate_weight
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
        expert_out = self.experts(moe_dispatch_einsum(tokens, dispatch))
        return moe_combine_einsum(expert_out, combine).reshape(orig_shape)


__all__ = ["GroupedExpertsFFN", "MoELayer", "NaiveGate", "SwitchGate",
           "GShardGate"]
