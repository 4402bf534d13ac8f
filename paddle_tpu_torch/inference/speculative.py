"""Draft/verify speculative decoding on the serving engine.

Counterpart of ``paddle_tpu/inference/speculative.py``. Every output
token normally costs one target decode tick. With a small draft model
the engine instead runs k + 1 cheap draft steps plus ONE target forward
that scores all k + 1 positions at once (``Engine._dispatch_spec``).
Acceptance is exact-match against the target's own sampling chain
(``generation.verify_token_arrays``): a drafted token is kept only when
it equals the token the target emits there, so the engine's output with
a draft attached is the draft-free engine's, 1 to k + 1 tokens a tick.

The draft model's paged pools mirror the engine's geometry — the same
page size, page count and block tables — so one allocator and one prefix
cache govern both models: a page id handed to a request addresses its
chunk in both pools, a shared prefix page carries both models' KV for
those tokens, and preemption and eviction stay single bookkeeping.
Rejected positions hold stale KV above each sequence's valid length;
the next tick's writes start there, and causal masking hides them
meanwhile.

The draft decodes greedily (argmax: no generator is touched); on
``cuda`` each of its single-token steps runs the CUDA paged-decode
kernel. ``sabotage`` corrupts a drafted chunk on purpose (the engine's
``spec.disagree`` fault point).
"""
from __future__ import annotations

import torch

from ..kernels.paged_attention import paged_kernel_requirements
from ..text.generation import _model_forward
from .engine import (_make_paged_pools, has_kv_forward, inject_bt,
                     serving_model_spec)


class SpeculativeDecoder:
    """The draft side of the engine's draft/verify schedule: the draft
    model, its paged pools, the draft prefill (mirroring each target
    prefill chunk) and the k + 1-step draft loop. The verify forward
    lives in the engine (it is the target's)."""

    def __init__(self, engine, draft_model, k: int):
        if int(k) < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        if not has_kv_forward(draft_model):
            raise ValueError(
                "speculative decoding needs a draft model with "
                "kv_caches/cache_index forward kwargs; "
                f"{type(draft_model).__name__}.forward has none")
        spec = serving_model_spec(draft_model)
        if spec.get("kind") != "decoder":
            raise ValueError(
                f"the draft model {type(draft_model).__name__} is not a "
                f"decoder (serving_spec kind {spec.get('kind')!r})")
        if int(spec["vocab_size"]) != engine.vocab_size:
            raise ValueError(
                f"draft vocab ({spec['vocab_size']}) must match the "
                f"target vocab ({engine.vocab_size}) — drafted ids are "
                f"verified against target logits position for position")
        if int(spec["max_context"]) < engine.max_context:
            raise ValueError(
                f"draft max_context ({spec['max_context']}) is shorter "
                f"than the engine max_context ({engine.max_context})")
        params = list(draft_model.parameters())
        if params and params[0].device != engine.device:
            raise ValueError(
                f"the draft model lives on {params[0].device} but the "
                f"engine serves on {engine.device}")
        hkv, hd = int(spec["kv_heads"]), int(spec["head_dim"])
        if engine.device.type == "cuda":
            # the draft's pools take the engine's page geometry and cache
            # dtype: the decode kernel must take them with its heads too
            why = paged_kernel_requirements(int(spec["num_heads"]), hkv,
                                            hd, engine.cache_dtype)
            if why:
                raise ValueError(
                    f"the CUDA paged-decode kernel cannot serve the draft "
                    f"model's geometry: {why}")
        self.engine = engine
        self.model = draft_model
        self.k = int(k)
        self._pools = _make_paged_pools(
            int(spec["num_layers"]), engine.pool_pages + 1, hkv,
            engine.page_size, hd, engine.cache_dtype, engine._quant,
            engine.device)

    def prefill(self, bt_row, prompt, start) -> None:
        """Mirror one target prefill chunk into the draft pools (the same
        bucket, block-table row and start offset)."""
        _model_forward(self.model, prompt, inject_bt(self._pools, bt_row),
                       start)

    def draft(self, bt, last, pos, live):
        """k proposals a slot from the decode state ([S] last tokens,
        positions, live flags; idle lanes at cache index -1): k + 1
        single-token draft steps, step j feeding the newest token at
        position pos + j. The (k+1)-th step writes the last proposal's
        KV, so the draft cache stays complete through a fully accepted
        tick; its output is dropped. Returns drafts [S, k]."""
        caches = inject_bt(self._pools, bt)
        tok, p = last, pos
        out = []
        for _ in range(self.k + 1):
            idx = torch.where(live > 0, p, torch.full_like(p, -1))
            logits = _model_forward(self.model, tok[:, None], caches, idx)
            tok = torch.argmax(logits[:, -1].float(), dim=-1)
            out.append(tok)
            p = p + live
        return torch.stack(out[:self.k], dim=1)

    def sabotage(self, drafts):
        """Corrupt a drafted chunk (the engine's ``spec.disagree`` fault
        point): every proposal shifts to a DIFFERENT in-vocab token, a
        draft/target divergence storm. Exact-match verification then
        rejects (almost) all of them; the emitted stream stays the
        draft-free engine's, each tick shrinking toward 1 token. Runs on
        the drafts' device, with no host round trip."""
        return (drafts + 1) % self.engine.vocab_size
