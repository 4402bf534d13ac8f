"""ERNIE-MoE causal LM (counterpart of
``paddle_tpu/text/models/ernie_moe.py``).

Decoder blocks alternate dense (SwiGLU ``LlamaMLP``) and MoE FFNs: block
i is an MoE block when i % moe_every == moe_every - 1, its ``MoELayer``
with a GShard gate, the config's top-k and capacity factor, and the
dispatch mode ``moe_dispatch_mode`` ("pallas": the grouped-FFN kernels).
Attention is the port's ``LlamaAttention``: the flash kernels without a
cache, and with one every layout it takes (dense, int8 dense, rolling,
paged).

- Without a cache the forward returns logits (:147-149); training adds
  ``aux_loss()`` to its loss.
- With a cache (the serving ``Engine``, or ``text.generate`` /
  ``beam_search``) every MoE block runs in decode mode (:127-146,
  :84-97): no capacity drops, and a live-lane mask from
  ``cache_index >= 0`` (the engine's idle lanes sit at -1), so a dead lane
  claims no expert slot and the kernels skip it. One-shot decoding
  passes one scalar index >= 0: every lane is live.

Expert parallelism: with the mesh's ``ep`` axis of n > 1 ranks (or a
``moe_group``), each MoE block holds its E / n experts
(``incubate/distributed/models/moe/moe_layer.py``); the weights are drawn
at their global shapes and sliced, so any ep degree builds the same
global model from a seed, and ``bridge.ernie_moe_state_from_numpy(...,
ep_rank, ep_degree)`` slices the JAX weights the same way.

Parameter names equal the JAX names (``layers.1.mlp.experts.w1``,
``layers.1.mlp.gate_weight``, ...; no ``llama.`` prefix), so
``bridge.ernie_moe_state_from_numpy`` maps one set of weights onto the
other.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ...core.device import resolve_device
from ...incubate.distributed.models.moe import MoELayer
from .llama import (LlamaAttention, LlamaConfig, LlamaMLP, LlamaRMSNorm,
                    _check_supported, _linear)


@dataclass
class ErnieMoEConfig(LlamaConfig):
    num_experts: int = 8
    moe_every: int = 2          # every Nth block uses an MoE FFN
    top_k: int = 2
    capacity_factor: float = 2.0
    aux_loss_coeff: float = 0.01
    moe_group_size: int = 2048  # GShard group-wise routing (einsum mode)
    moe_dispatch_mode: str = "pallas"

    @staticmethod
    def tiny(vocab=128, hidden=64, layers=2, heads=4, experts=4):
        return ErnieMoEConfig(
            vocab_size=vocab, hidden_size=hidden,
            intermediate_size=hidden * 2, num_hidden_layers=layers,
            num_attention_heads=heads, num_key_value_heads=heads,
            num_experts=experts)


class ErnieMoEDecoderLayer(nn.Module):
    def __init__(self, config: ErnieMoEConfig, use_moe: bool, device=None,
                 dtype=None, moe_group=None):
        super().__init__()
        c = config
        self.input_layernorm = LlamaRMSNorm(c.hidden_size, c.rms_norm_eps,
                                            device, dtype)
        self.self_attn = LlamaAttention(c, device, dtype)
        self.post_attention_layernorm = LlamaRMSNorm(
            c.hidden_size, c.rms_norm_eps, device, dtype)
        if use_moe:
            self.mlp = MoELayer(
                d_model=c.hidden_size, d_hidden=c.intermediate_size,
                num_experts=c.num_experts, gate="gshard", top_k=c.top_k,
                capacity_factor=c.capacity_factor,
                group_size=c.moe_group_size,
                dispatch_mode=c.moe_dispatch_mode, moe_group=moe_group,
                device=device, dtype=dtype)
        else:
            self.mlp = LlamaMLP(c, device, dtype)
        self.is_moe = use_moe

    def forward(self, x, kv_cache=None, cache_index=None, token_mask=None):
        if kv_cache is not None:
            attn, new_cache = self.self_attn(
                self.input_layernorm(x), kv_cache=kv_cache,
                cache_index=cache_index)
            x = x + attn
            h = self.post_attention_layernorm(x)
            if self.is_moe:
                # serving decode mode: no-drop routing, dead lanes masked
                x = x + self.mlp(h, token_mask=token_mask, decode_mode=True)
            else:
                x = x + self.mlp(h)
            return x, new_cache
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class ErnieMoEForCausalLM(nn.Module):
    """The MoE causal LM. ``device=None`` builds it on ``cuda`` (raising
    when no GPU is visible); ``device="cpu"`` runs the plain versions of
    the kernels. Weights are drawn from ``seed`` (normal, std
    ``init_std``; norms at 1, expert biases at 0) — or loaded with
    ``load_state_dict`` (``bridge.ernie_moe_state_from_numpy``)."""

    def __init__(self, config: ErnieMoEConfig, device=None, seed: int = 0,
                 init_std: float = 0.02, moe_group=None):
        super().__init__()
        _check_supported(config)
        c = config
        self.config = c
        self.device = resolve_device(device)
        dtype = getattr(torch, c.dtype)
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size,
                                         device=self.device, dtype=dtype)
        self.layers = nn.ModuleList([
            ErnieMoEDecoderLayer(
                c, use_moe=(i % c.moe_every == c.moe_every - 1),
                device=self.device, dtype=dtype, moe_group=moe_group)
            for i in range(c.num_hidden_layers)])
        self.norm = LlamaRMSNorm(c.hidden_size, c.rms_norm_eps, self.device,
                                 dtype)
        self.lm_head = _linear(c.hidden_size, c.vocab_size, self.device,
                               dtype)
        self.reset_parameters(seed, init_std)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0, init_std: float = 0.02):
        """Norms at 1, expert biases 0, every other parameter normal(0,
        ``init_std``) from one generator in parameter order; an
        expert-parallel shard drawn at its global shape and sliced."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        modules = dict(self.named_modules())
        for name, p in self.named_parameters():
            mname, _, pname = name.rpartition(".")
            m = modules[mname]
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith(("experts.b1", "experts.b2")):
                p.zero_()
            elif getattr(m, "ep_degree", 1) > 1:
                full = torch.empty(m.global_shape(pname), device=p.device,
                                   dtype=p.dtype)
                p.copy_(m.shard(full.normal_(0.0, init_std, generator=gen)))
            else:
                p.normal_(0.0, init_std, generator=gen)

    def forward(self, input_ids, kv_caches=None, cache_index=None):
        """Logits [b, s, vocab]; with ``kv_caches`` (any layout of
        ``LlamaAttention._cached_attention``: a per-sequence [b]
        ``cache_index`` for the paged serving layout, one scalar for every
        layout in one-shot decoding) also the updated caches."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        x = self.embed_tokens(input_ids)
        if kv_caches is not None:
            b, s = input_ids.shape
            idx = torch.as_tensor(cache_index, device=self.device)
            # the engine's idle-lane convention: a dead decode slot rides
            # at cache_index -1 and must claim no expert capacity; a
            # scalar index (>= 0) leaves every lane live, bucket padding
            # of a prefill chunk included (no-drop capacity keeps its
            # routing harmless to real tokens)
            mask = (idx.reshape(-1, 1) >= 0).expand(b, s)
            new_caches = []
            for lyr, cache in zip(self.layers, kv_caches):
                x, nc = lyr(x, kv_cache=cache, cache_index=cache_index,
                            token_mask=mask)
                new_caches.append(nc)
            return self.lm_head(self.norm(x)), new_caches
        for lyr in self.layers:
            x = lyr(x)
        return self.lm_head(self.norm(x))

    def moe_layers(self):
        return [lyr.mlp for lyr in self.layers if lyr.is_moe]

    def serving_spec(self):
        """Engine geometry probe: the decoder's KV geometry (with
        ``num_heads``, which the decode kernel's check needs) plus the MoE
        block; ``moe_layer`` is the first MoE block, whose fallback reason
        the engine reads once at construction."""
        c = self.config
        spec = {
            "kind": "decoder",
            "num_layers": c.num_hidden_layers,
            "kv_heads": c.num_key_value_heads,
            "num_heads": c.num_attention_heads,
            "head_dim": c.hidden_size // c.num_attention_heads,
            "max_context": c.max_position_embeddings,
            "vocab_size": c.vocab_size,
        }
        moe = self.moe_layers()
        if moe:
            spec["moe"] = {
                "num_experts": c.num_experts, "top_k": c.top_k,
                "d_model": c.hidden_size, "d_hidden": c.intermediate_size,
                "dispatch_mode": c.moe_dispatch_mode,
                "num_moe_layers": len(moe)}
            spec["moe_layer"] = moe[0]
        return spec

    def aux_loss(self):
        """Sum of the MoE load-balancing losses of the last forward, times
        ``aux_loss_coeff``, in f32 (the JAX package's scalar product
        promotes a bf16 sum to f32)."""
        auxes = [m.l_aux for m in self.moe_layers() if m.l_aux is not None]
        if not auxes:
            raise RuntimeError("aux_loss read before any forward")
        return sum(auxes[1:], auxes[0]).float() * self.config.aux_loss_coeff


def ernie_moe_flops_per_token(config: ErnieMoEConfig) -> float:
    """Approximate training FLOPs per token with routed expert accounting
    (6 x the parameters a token visits: the top_k experts of an MoE block
    plus its router; :192)."""
    c = config
    L = c.num_hidden_layers
    n_moe = sum(1 for i in range(L) if i % c.moe_every == c.moe_every - 1)
    n_dense = L - n_moe
    attn = 4 * c.hidden_size * c.hidden_size
    dense_ffn = 3 * c.hidden_size * c.intermediate_size   # SwiGLU
    expert_ffn = c.top_k * 2 * c.hidden_size * c.intermediate_size
    router = c.hidden_size * c.num_experts
    embed_head = 2 * c.vocab_size * c.hidden_size
    active = (embed_head + n_dense * (attn + dense_ffn)
              + n_moe * (attn + expert_ffn + router))
    return 6.0 * active
