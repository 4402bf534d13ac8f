"""MoE gates: naive / switch (top-1) / gshard (top-2) (counterpart of
``paddle_tpu/incubate/distributed/models/moe/gate.py``).

Routing as in the JAX package: softmax in the logits' dtype, top-k argmax
rounds over the probabilities with the chosen experts masked out between
rounds, a running per-expert occupancy, the capacity drop, Switch (top-1:
the raw router probability) or GShard (top-k: the kept probabilities
renormalized per token) combine weights, and the load-balancing aux loss
over the first choice.

One divergence by design: a token's slot in its expert's buffer is
counted in int32. The JAX package counts it as a cumsum of a one-hot in
the logits' dtype (:39, :145), and bf16 holds integers exactly only up to
256, so under bf16 AMP positions past 256 round and tokens collide in one
slot. The two agree exactly wherever JAX's positions are exact (f32
logits, or fewer than 256 tokens per expert per round).
"""
from __future__ import annotations

import math

import torch


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              top_k: int) -> int:
    cap = int(math.ceil(top_k * num_tokens / num_experts * capacity_factor))
    return max(cap, 4)


def apply_router_jitter(logits, jitter: float, train: bool, generator=None):
    """Additive uniform router noise in [-jitter, jitter) (Switch-style),
    drawn from ``generator`` (the global generator when None). The one
    definition the single-group and group-wise paths share."""
    if jitter and train:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
        logits = logits + (jitter * (2.0 * u - 1.0)).to(logits.dtype)
    return logits


def topk_gating_sparse(logits, top_k: int, capacity: int, train: bool = True,
                       generator=None, switch_jitter: float = 0.0,
                       token_mask=None):
    """Sparse routing: (expert_idx [k, N] int32, pos [k, N] int32, keep
    [k, N] bool, combine_w [k, N] in the logits' dtype, aux scalar).

    ``token_mask`` ([N] bool, optional) marks dead tokens False (the
    serving engine's idle decode lanes): they claim no occupancy, are
    never kept, and live tokens route exactly as if they were absent."""
    n, e = logits.shape
    logits = apply_router_jitter(logits, switch_jitter, train, generator)
    probs = torch.softmax(logits, dim=-1)
    masked = probs
    occupancy = torch.zeros((1, e), dtype=torch.int32, device=logits.device)
    live = None if token_mask is None else \
        token_mask.reshape(-1).to(torch.bool)
    idxs, poss, keeps, gates = [], [], [], []
    first_choice = None
    for r in range(top_k):
        idx = torch.argmax(masked, dim=-1)
        if r == 0:
            first_choice = idx
        onehot = torch.nn.functional.one_hot(idx, e).to(torch.int32)
        if live is not None:
            onehot = onehot * live[:, None].to(torch.int32)
        # the running count per expert, scanned along the contiguous token
        # axis of the [E, N] transpose: PyTorch's CUDA scan over the N rows
        # of [N, E] runs only E-wide
        pos_in = torch.cumsum(onehot.t().contiguous(), dim=1,
                              dtype=torch.int32).t() - onehot + occupancy
        pos = (pos_in * onehot).sum(dim=1, dtype=torch.int32)
        keep = pos < capacity
        if live is not None:
            keep = keep & live
        g = torch.gather(probs, 1, idx[:, None])[:, 0] * keep.to(probs.dtype)
        occupancy = occupancy + onehot.sum(dim=0, keepdim=True,
                                           dtype=torch.int32)
        idxs.append(idx.to(torch.int32))
        poss.append(pos)
        keeps.append(keep)
        gates.append(g)
        masked = masked * (1.0 - onehot.to(probs.dtype))

    if top_k == 1:
        weights = gates
    else:
        denom = torch.clamp_min(sum(gates), 1e-9)
        weights = [g / denom for g in gates]
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(first_choice, e).to(probs.dtype).mean(0)
    aux = e * (me * ce).sum()
    return (torch.stack(idxs), torch.stack(poss), torch.stack(keeps),
            torch.stack(weights).to(logits.dtype), aux)


def topk_gating(logits, top_k: int, capacity: int, train: bool = True,
                generator=None, switch_jitter: float = 0.0):
    """Dense routing: (dispatch [N, E, C], combine [N, E, C], aux), both
    in the logits' dtype — the one-hot form of ``topk_gating_sparse``'s
    decisions (the same rounds, occupancy, drop and weights)."""
    n, e = logits.shape
    idx, pos, keep, w, aux = topk_gating_sparse(
        logits, top_k, capacity, train, generator, switch_jitter)
    dt = logits.dtype
    dispatch = torch.zeros((n, e, capacity), dtype=dt, device=logits.device)
    combine = torch.zeros_like(dispatch)
    tok = torch.arange(n, device=logits.device)
    for r in range(top_k):
        k = keep[r]
        t, ei, ci = tok[k], idx[r][k].long(), pos[r][k].long()
        dispatch = dispatch.index_put((t, ei, ci),
                                      torch.ones_like(t, dtype=dt))
        combine = combine.index_put((t, ei, ci), w[r][k])
    return dispatch, combine, aux


class BaseGate:
    def __init__(self, num_experts: int, top_k: int,
                 capacity_factor: float = 1.25, jitter: float = 0.0):
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.jitter = jitter

    def capacity(self, num_tokens: int) -> int:
        return _capacity(num_tokens, self.num_experts, self.capacity_factor,
                         self.top_k)

    def __call__(self, logits, train=True, generator=None):
        cap = self.capacity(logits.shape[0])
        return topk_gating(logits, self.top_k, cap, train=train,
                           generator=generator, switch_jitter=self.jitter)


class NaiveGate(BaseGate):
    """top-k argmax routing, no jitter."""

    def __init__(self, num_experts, top_k=2, capacity_factor=1.25):
        super().__init__(num_experts, top_k, capacity_factor, 0.0)


class SwitchGate(BaseGate):
    """top-1 routing with optional jitter."""

    def __init__(self, num_experts, capacity_factor=1.25, jitter=0.01):
        super().__init__(num_experts, 1, capacity_factor, jitter)


class GShardGate(BaseGate):
    """top-2 routing."""

    def __init__(self, num_experts, capacity_factor=2.0):
        super().__init__(num_experts, 2, capacity_factor, 0.0)
