"""LLaMA causal LM (counterpart of ``paddle_tpu/text/models/llama.py``).

The serving, training and decode slices of the port: ``LlamaConfig``,
RMSNorm, attention (the no-cache branch with flashmask, :221-291, and
the four KV-cache layouts: dense and int8 dense, :293-375, paged,
:377-487, rolling, :489-567), the SwiGLU MLP, the decoder stack with
per-layer recompute, full or selective (:669-700), the causal-LM head,
the fused chunked LM loss when ``labels`` are given (:746-754),
``serving_spec`` (:760), ``build_llama_pipe`` (:786, the pipeline view) and
``llama_flops_per_token`` (:837). Module and
parameter names match the JAX package, so
``bridge.llama_state_from_numpy`` maps one set of weights onto the
other.

Attention paths:

- no cache: ``kernels.flash_attention`` — the CUDA flash forward kernel
  (and, when a gradient is taken, the two CUDA backward kernels) on the
  GPU, their plain versions on the CPU; with
  ``use_flash_attention=False`` and no window, the plain
  ``nn.functional.scaled_dot_product_attention(use_flash=False)`` core
  over k / v repeated to the query heads (the JAX escape hatch, :259-286);
- dense cache ``(k, v)`` / ``(k, v, k_scale, v_scale)`` (int8, one scale
  a token and kv head) and rolling cache ``(k, v, pos)`` / ``(k, v, pos,
  k_scale, v_scale)`` (``C`` slots, ``pos`` [C] each slot's position, -1
  = empty): written in place at one scalar ``cache_index`` and attended
  with plain PyTorch in f32 (``_attend_cache``), as the JAX package does
  with XLA;
- paged cache, one token per sequence (a decode tick):
  ``kernels.paged_attention.paged_decode`` — the CUDA paged-decode
  kernel on the GPU, its plain version on the CPU;
- paged cache, several tokens (a prefill chunk): the sequence's pages
  are gathered and attended with plain PyTorch in f32, as the JAX
  package does it with XLA (:453-470).

Recompute granularities (``recompute=True``): "full" checkpoints the
whole layer and keeps only its input. "selective" keeps what the JAX
policy saves by name, the attention output (``attn_core``) and the SwiGLU
product (``ffn_mid``), by where its regions end: the layer runs as two
checkpointed regions, norm -> q/k/v -> rope -> flash and norm -> gate/up
-> SwiGLU, with o_proj, down_proj and the residual adds outside them. The
rerun then stops at the regions' ends, as XLA's drops what the saved
names make dead; the region outputs are kept by the products that read
them, at no copy, and the second region's input (the residual after
attention) is kept too. "selective_qkv" also keeps q, k and v after rope:
they are tagged (``attn_q`` / ``attn_k`` / ``attn_v``, not on the
flashmask path, as in the JAX model) and the attention region runs under
``save_only_names`` of them. See ``distributed/fleet/recompute.py``.

Tensor parallelism (:184-196, :580-584, :632, :715): under a hybrid
topology with ``mp`` > 1 (``fleet.init``), or inside
``force_tp_layers()``, q / k / v, gate / up and the head are
``ColumnParallelLinearModule``s, o_proj and down_proj
``RowParallelLinearModule``s and the embedding a
``VocabParallelEmbeddingModule`` (``distributed/fleet/layers/mpu``): each
rank holds its shard, and its attention runs its heads (h / mp query and
h_kv / mp kv heads). ``reset_parameters`` draws every parameter at its
global shape from the seed's generator and keeps this rank's shard, so
any mp degree builds the same global model. The logits are gathered
(``gather_output``, as the JAX head); the fused LM loss is
vocabulary-parallel: each rank's chunk logits stay a [rows, V / mp]
shard, with three all-reduces a chunk (``fused_linear_cross_entropy``'s
``group``).

Sequence parallelism over mp (``sequence_parallel`` at mp > 1; JAX
:664-668, where GSPMD places the collectives): the embedding's output is
split along the sequence over the mp group (``ScatterOp``); each layer's
norms and residuals run on the rank's s / mp rows, q / k / v and gate /
up are ``ColumnSequenceParallelLinearModule``s fed one all-gather a group
(``AllGatherOp``, whose backward reduce-scatters), o_proj and down_proj
``RowSequenceParallelLinearModule``s (reduce-scatter back to the split);
the sequence is gathered (``GatherOp``) before the final norm and the
head. The norms' weights are sequence-parallel parameters (their
gradients summed over mp by the step or the optimizer). The weights are
the TP layers' shards, so ``bridge.TP_RULES`` hold. Flashmask with it
raises, as in JAX (:646-651).

Context parallelism over ``sep`` (a model built on a mesh whose sep
degree is > 1, JAX :229-234 and :259-276; the sep group is kept from
construction, as the TP layers are): each rank holds a chunk of the
sequence (dim 1 of the ids, split by ``SegmentParallel`` or
``DistributedTrainStep``, or fed so by the caller); attention is
``kernels.ring_attention.ring_flash_attention`` over that group with the
layer's window; rope takes the chunk's global positions (``sep_rank *
s_local`` on), which the JAX package gets from its global shapes; the
fused loss is the whole sequence's mean, its gradient the chunk's part
(``fused_linear_cross_entropy``'s ``seq_group``), and a forward that
would hand out the chunk's logits for a loss of the caller's raises
unless gradients are off. Flashmask with sep raises, as in JAX.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ...core.device import resolve_device
from ...distributed import mesh as mesh_mod
from ...distributed.fleet.layers.mpu.mp_layers import (
    ColumnParallelLinearModule, RowParallelLinearModule,
    VocabParallelEmbeddingModule, global_shape, shard_of)
from ...distributed.fleet.layers.mpu.mp_ops import _c_concat, _c_identity
from ...distributed.fleet.utils.sequence_parallel_utils import (
    AllGatherOp, ColumnSequenceParallelLinearModule, GatherOp,
    RowSequenceParallelLinearModule, ScatterOp,
    mark_as_sequence_parallel_parameter)
from ...distributed.fleet.recompute import (checkpoint_name, recompute,
                                             save_only_names)
from ...incubate.nn.functional import (fused_linear_cross_entropy,
                                       fused_rotary_position_embedding)
from ...nn import functional as F

NEG_INF_ATTN = -1e30


def _attend_cache(qa, kk, vv, mask, rep):
    """Masked softmax attention of qa [b, s, h, d] against gathered cache
    keys/values [b, L, h_kv, d]; mask [s, L] or [b, s, L]. Computed in
    f32 whatever the cache dtype (a bf16 pool is upcast, not rounded
    further)."""
    if rep != 1:
        kk = kk.repeat_interleave(rep, dim=2)
        vv = vv.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(qa.shape[-1])
    logits = torch.einsum("bshd,bLhd->bhsL", qa.float(), kk.float()) * scale
    mexp = mask[None, None] if mask.dim() == 2 else mask[:, None]
    logits = torch.where(mexp, logits,
                         torch.full_like(logits, NEG_INF_ATTN))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhsL,bLhd->bshd", p, vv.float()).to(qa.dtype)


def _scalar_index(cache_index, device):
    """The one cache index a dense or rolling cache takes for the whole
    batch, as a 0-d int64 tensor on ``device`` (no copy when it is one)."""
    idx = torch.as_tensor(cache_index, device=device)
    if idx.numel() != 1:
        raise ValueError(
            "dense and rolling KV caches take one scalar cache_index for "
            f"the whole batch, got shape {tuple(idx.shape)}")
    return idx.reshape(()).to(torch.int64)


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    sliding_window: Optional[int] = None
    sequence_parallel: bool = False
    recompute: bool = False
    recompute_granularity: str = "full"
    fused_linear_ce: bool = False
    fused_ce_chunks: int = 8
    dtype: str = "float32"

    @staticmethod
    def tiny(vocab=128, hidden=64, layers=2, heads=4):
        return LlamaConfig(
            vocab_size=vocab, hidden_size=hidden,
            intermediate_size=hidden * 4 // 2 * 2,
            num_hidden_layers=layers, num_attention_heads=heads,
            num_key_value_heads=heads, max_position_embeddings=256)


def _check_supported(c: LlamaConfig):
    if c.recompute and c.recompute_granularity not in GRANULARITIES:
        raise ValueError(
            f"recompute_granularity={c.recompute_granularity!r}: expected "
            f"'full', 'selective' or 'selective_qkv'")
    if c.sliding_window is not None and int(c.sliding_window) < 1:
        raise ValueError(
            f"sliding_window must be >= 1, got {c.sliding_window}")


# Under force_tp_layers the parallel module classes are used even at
# mp=1 (where they compute what the plain ones do), so that one run can
# build the module tree of a TP run (:132-159).
_FORCE_TP = False


class force_tp_layers:
    """Build LLaMA modules with the parallel classes whatever the
    topology's mp degree (a context manager)."""

    def __enter__(self):
        global _FORCE_TP
        self._prev = _FORCE_TP
        _FORCE_TP = True
        return self

    def __exit__(self, *exc):
        global _FORCE_TP
        _FORCE_TP = self._prev
        return False


def _use_tp():
    return _FORCE_TP or mesh_mod.axis_degree("mp") > 1


def _use_sp(config) -> bool:
    """Sequence parallelism over mp (JAX :664: ``sequence_parallel`` at
    mp > 1)."""
    return bool(config.sequence_parallel) and mesh_mod.axis_degree("mp") > 1


def _sep_group():
    """The sep group when the mesh splits the sequence over it, else None:
    read when a model is built, which then keeps it (its attention, rope
    offsets and loss are fixed at construction, as its TP layers are)."""
    if mesh_mod.axis_degree("sep") <= 1:
        return None
    return mesh_mod.get_mesh().group("sep")


def _tp_input(x, first):
    """The input of a group of column-parallel products (``first`` one of
    them): under TP ``_c_identity`` once, so that its gradient is
    all-reduced once for the group; under sequence parallelism the
    sequence's all-gather once (its backward reduce-scatters)."""
    if isinstance(first, ColumnSequenceParallelLinearModule):
        return AllGatherOp.apply(x, first.group)
    if isinstance(first, ColumnParallelLinearModule):
        return _c_identity(x, group=first.group)
    return x


def _tp_divide(n, what):
    mp = mesh_mod.axis_degree("mp")
    if n % mp:
        raise ValueError(f"{what} ({n}) must be divisible by the "
                         f"model-parallel degree ({mp})")
    return n // mp


#: the recompute granularities (llama.py:677-684)
GRANULARITIES = ("full", "selective", "selective_qkv")
#: the tags "selective_qkv" saves in the attention region
QKV_TAGS = ("attn_q", "attn_k", "attn_v")


def _tags_qkv(config: LlamaConfig) -> bool:
    """Whether the attention tags q, k and v for a selective policy."""
    return config.recompute and \
        config.recompute_granularity == "selective_qkv"


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden_size, eps=1e-6, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))
        self.eps = eps

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.eps)


def _linear(i, o, device, dtype):
    return nn.Linear(i, o, bias=False, device=device, dtype=dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        c = config
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.window = None if c.sliding_window is None \
            else int(c.sliding_window)
        self.use_flash = c.use_flash_attention
        self._tag_qkv = _tags_qkv(c)
        # the sequence split over sep this layer takes (the ring), if any
        self.sep_group = _sep_group()
        hs = c.hidden_size
        kv = self.num_kv_heads * self.head_dim
        if _use_tp():
            self.num_heads = _tp_divide(self.num_heads, "num_attention_heads")
            self.num_kv_heads = _tp_divide(self.num_kv_heads,
                                           "num_key_value_heads")
            sp = _use_sp(c)
            col = functools.partial(
                ColumnSequenceParallelLinearModule if sp
                else ColumnParallelLinearModule, device=device, dtype=dtype,
                sync_input_grad=False)
            row = RowSequenceParallelLinearModule if sp \
                else RowParallelLinearModule
            self.q_proj, self.k_proj, self.v_proj = (
                col(hs, hs), col(hs, kv), col(hs, kv))
            self.o_proj = row(hs, hs, device=device, dtype=dtype)
        else:
            self.q_proj = _linear(hs, hs, device, dtype)
            self.k_proj = _linear(hs, kv, device, dtype)
            self.v_proj = _linear(hs, kv, device, dtype)
            self.o_proj = _linear(hs, hs, device, dtype)

    def forward(self, x, kv_cache=None, cache_index=None,
                attn_mask_startend_row_indices=None):
        if kv_cache is None:
            return self.o_proj(self.core(x, attn_mask_startend_row_indices))
        q, k, v = self._qkv(x, cache_index)
        return self._cached_attention(q, k, v, kv_cache, cache_index)

    def _qkv(self, x, cache_index=None):
        """q, k, v [b, s, heads, head_dim], q and k after rope."""
        x = _tp_input(x, self.q_proj)
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        position_ids = None
        if cache_index is not None:
            # rope positions continue from the cache write offset (a
            # scalar, or [b] per-slot offsets for the serving engine)
            idx = torch.as_tensor(cache_index, device=x.device).reshape(-1, 1)
            position_ids = (torch.arange(s, device=x.device)[None, :]
                            + idx).expand(b, s)
        elif self.sep_group is not None:
            # this sep rank's chunk of the sequence: its global positions
            off = self.sep_group.rank * s
            position_ids = (torch.arange(s, device=x.device)[None, :]
                            + off).expand(b, s)
        q, k, _ = fused_rotary_position_embedding(
            q, k, None, position_ids=position_ids,
            use_neox_rotary_style=True)
        return q, k, v

    def core(self, x, attn_mask_startend_row_indices=None):
        """The no-cache attention up to o_proj (``attn_core``, [b, s,
        heads x head_dim]): q/k/v, rope and the flash kernel — or, with
        ``use_flash_attention=False`` and no window, the plain sdpa core
        over k / v repeated to the query heads (a window always takes
        the flash path, as in the JAX model)."""
        from ...kernels.flash_attention import flash_attention
        se = attn_mask_startend_row_indices
        sep = self.sep_group is not None
        if se is not None and sep:
            raise ValueError(
                "attn_mask_startend_row_indices is not supported under "
                "sequence/context parallelism (sep > 1): ring attention "
                "rotates K/V blocks and cannot apply per-column band masks "
                "yet")
        if se is not None and self.window is not None:
            raise ValueError(
                "attn_mask_startend_row_indices cannot be combined with "
                "sliding_window — express the window as extra mask bands "
                "instead")
        if se is not None and not self.use_flash:
            raise ValueError(
                "attn_mask_startend_row_indices requires "
                "use_flash_attention=True (the flashmask bands only exist "
                "on the flash path)")
        q, k, v = self._qkv(x)
        b, s = q.shape[:2]
        if self._tag_qkv and se is None:
            q, k, v = (checkpoint_name(t, n)
                       for t, n in zip((q, k, v), QKV_TAGS))
        if sep:
            from ...kernels.ring_attention import ring_flash_attention
            out = ring_flash_attention(q, k, v, causal=True,
                                       window=self.window,
                                       group=self.sep_group)
        elif self.use_flash or self.window is not None:
            out = flash_attention(q, k, v, causal=True, window=self.window,
                                  startend_row_indices=se)
        else:
            rep = self.num_heads // self.num_kv_heads
            if rep != 1:
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 use_flash=False)
        return out.reshape(b, s, self.num_heads * self.head_dim)

    def _cached_attention(self, q, k, v, kv_cache, cache_index):
        """KV-cache attention, routed by the cache tuple as in the JAX
        model (:315-321):

        - (k, v): dense [b, L, h_kv, d] cache, any float dtype;
        - (k, v, k_scale, v_scale): dense int8 cache with f32 scales
          [b, L, h_kv], one a token and kv head;
        - (k_pool, v_pool, block_tables[, k_scale, v_scale]) with 2-D
          block tables: paged (see kernels/paged_attention.py);
        - (k, v, pos[, k_scale, v_scale]) with 1-D pos: rolling buffer of
          C slots, C = ``sliding_window`` (or less).

        Every layout is written IN PLACE: the returned tuple holds the
        same (updated) tensors."""
        if len(kv_cache) in (3, 5) and kv_cache[2].dim() == 2:
            return self._paged_cached_attention(q, k, v, kv_cache,
                                                cache_index)
        if len(kv_cache) in (3, 5):
            return self._rolling_cached_attention(q, k, v, kv_cache,
                                                  cache_index)
        if len(kv_cache) not in (2, 4):
            raise ValueError(
                f"a KV cache is a tuple of 2 or 4 (dense), 3 or 5 (paged "
                f"or rolling) tensors, got {len(kv_cache)}")
        return self._dense_cached_attention(q, k, v, kv_cache, cache_index)

    def _done(self, out, kv_cache):
        b, s = out.shape[0], out.shape[1]
        out = out.reshape(b, s, self.num_heads * self.head_dim)
        return self.o_proj(out), tuple(kv_cache)

    def _dense_cached_attention(self, q, k, v, kv_cache, cache_index):
        """Dense cache (JAX :293-375): this call's k / v written at
        [idx, idx + s) (int8: quantized per token and kv head), then q
        attends the cache, so the chunk sees its own (quantized) k / v;
        the mask keeps k_pos <= q_pos and, with a window,
        q_pos - k_pos < window.

        With a window shorter than the cache, q attends only positions
        [idx - window, idx + s), in order: the keys, shapes and order the
        rolling layout attends (its C = window slots by position, then
        the chunk), so the two layouts compute the same sums and give the
        same tokens bit for bit. Otherwise the whole cache."""
        from ... import monitor
        from ...quantization.functional import kv_quantize_arrays
        monitor.counter("kernels.decode.dense").increase()
        rep = self.num_heads // self.num_kv_heads
        window = self.window
        ck, cv = kv_cache[:2]
        quant = len(kv_cache) == 4
        s, L = q.shape[1], ck.shape[1]
        idx = _scalar_index(cache_index, q.device)
        q_pos = idx + torch.arange(s, device=q.device)
        if quant:
            ks, vs = kv_cache[2:]
            (qk, sk), (qv, sv) = kv_quantize_arrays(k), kv_quantize_arrays(v)
            writes = ((ck, qk), (cv, qv), (ks, sk), (vs, sv))
        else:
            writes = ((ck, k), (cv, v))
        for dst, src in writes:
            dst.index_copy_(1, q_pos, src.to(dst.dtype))
        if window is not None and window < L:
            k_pos = idx - window + torch.arange(window + s, device=q.device)
            take = k_pos.clamp(0, L - 1)

            def sel(t):
                return t.index_select(1, take)
        else:
            k_pos = torch.arange(L, device=q.device)

            def sel(t):
                return t
        if quant:
            kk = sel(ck).float() * sel(ks)[..., None]
            vv = sel(cv).float() * sel(vs)[..., None]
        else:
            kk, vv = sel(ck), sel(cv)
        mask = (k_pos[None, :] >= 0) & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        return self._done(_attend_cache(q, kk, vv, mask, rep), kv_cache)

    def _rolling_cached_attention(self, q, k, v, kv_cache, cache_index):
        """Rolling buffer (JAX :489-567): C slots hold the window's K/V,
        pos[j] the absolute position of slot j (-1: never written). The
        chunk attends the cache AS IT STOOD before this call concatenated
        with itself (pos_cat = [pos, cur_pos]): a prefill longer than the
        window still sees, from its early rows, the keys the roll-in is
        about to evict, and the band mask hides stale slots (their
        positions are <= idx - C <= q_pos - window). Then only the last
        min(s, C) tokens are rolled in at new_pos % C. The int8 form sends
        the chunk through its own quantize -> dequantize round trip before
        it attends, as the dense int8 layout does.

        The slots are read in position order (slot (idx + j) % C holds
        position idx - C + j, or nothing), where the JAX package reads
        them in slot order: the dense layout reads the same keys in that
        order, and the two give the same tokens bit for bit."""
        from ... import monitor
        from ...quantization.functional import (kv_dequantize_arrays,
                                                kv_quantize_arrays)
        window = self.window
        if window is None:
            raise ValueError(
                "rolling (k, v, pos) caches require sliding_window")
        monitor.counter("kernels.decode.rolling").increase()
        rep = self.num_heads // self.num_kv_heads
        ck, cv, pos = kv_cache[:3]
        quant = len(kv_cache) == 5
        s, C = q.shape[1], ck.shape[1]
        idx = _scalar_index(cache_index, q.device)
        cur_pos = idx + torch.arange(s, device=q.device)
        order = torch.remainder(idx + torch.arange(C, device=q.device), C)

        def sel(t):
            return t.index_select(1, order)
        if quant:
            ks, vs = kv_cache[3:]
            (qk, sk), (qv, sv) = kv_quantize_arrays(k), kv_quantize_arrays(v)
            ka_c, va_c = kv_dequantize_arrays(qk, sk), kv_dequantize_arrays(
                qv, sv)
            ckf = sel(ck).float() * sel(ks)[..., None]
            cvf = sel(cv).float() * sel(vs)[..., None]
        else:
            ka_c, va_c = k.to(ck.dtype), v.to(cv.dtype)
            ckf, cvf = sel(ck), sel(cv)
        kk = torch.cat([ckf, ka_c.to(ckf.dtype)], dim=1)
        vv = torch.cat([cvf, va_c.to(cvf.dtype)], dim=1)
        pos_cat = torch.cat([pos.index_select(0, order).to(torch.int64),
                             cur_pos])                             # [C + s]
        mask = ((pos_cat[None, :] >= 0)
                & (pos_cat[None, :] <= cur_pos[:, None])
                & (cur_pos[:, None] - pos_cat[None, :] < window))
        out = _attend_cache(q, kk, vv, mask, rep)
        # roll the chunk in: only its last min(s, C) tokens survive
        lo = max(s - C, 0)
        new_pos = cur_pos[lo:]
        slots = torch.remainder(new_pos, C)
        if quant:
            writes = ((ck, qk), (cv, qv), (ks, sk), (vs, sv))
        else:
            writes = ((ck, k), (cv, v))
        for dst, src in writes:
            dst.index_copy_(1, slots, src[:, lo:].to(dst.dtype))
        pos.index_copy_(0, slots, new_pos.to(pos.dtype))
        return self._done(out, kv_cache)

    def _paged_cached_attention(self, q, k, v, kv_cache, cache_index):
        """Paged-KV attention: write this call's k/v at ``cache_index``
        (per sequence, [b] or a scalar) into the pools IN PLACE, then
        attend q against each sequence's pages. The returned cache tuple
        holds the same (updated) pool tensors."""
        from ... import monitor
        from ...kernels.paged_attention import (gather_page_scales,
                                                gather_pages, paged_decode,
                                                paged_write_arrays,
                                                paged_write_quant_arrays)
        window = self.window
        rep = self.num_heads // self.num_kv_heads
        quant = len(kv_cache) == 5
        kc, vc, bt = kv_cache[:3]
        ks, vs = (kv_cache[3], kv_cache[4]) if quant else (None, None)
        b, s = q.shape[0], q.shape[1]
        bs_ = kc.shape[2]
        pos0 = torch.as_tensor(cache_index, device=q.device).to(
            torch.int64).reshape(-1).expand(b)
        # the allocator guarantees capacity: no host-synced check here
        if quant:
            paged_write_quant_arrays(k, v, kc, vc, ks, vs, bt, pos0,
                                     check_capacity=False)
        else:
            paged_write_arrays(k, v, kc, vc, bt, pos0, check_capacity=False)
        if s == 1:
            # idle serving lanes sit at cache_index -1: context 0, a
            # dead slot for the kernel
            out = paged_decode(q[:, 0], kc, vc, bt, pos0 + 1, window=window,
                               k_scale=ks, v_scale=vs)[:, None]
        else:
            monitor.counter("kernels.decode.paged_gather").increase()
            L = bt.shape[1] * bs_
            kk = gather_pages(kc, bt)
            vv = gather_pages(vc, bt)
            if quant:
                kk = kk.float() * gather_page_scales(ks, bt)[..., None]
                vv = vv.float() * gather_page_scales(vs, bt)[..., None]
            q_pos = pos0[:, None] + torch.arange(s, device=q.device)[None]
            k_pos = torch.arange(L, device=q.device)
            mask = k_pos[None, None, :] <= q_pos[:, :, None]   # [b, s, L]
            if window is not None:
                mask = mask & (q_pos[:, :, None] - k_pos[None, None, :]
                               < window)
            out = _attend_cache(q, kk, vv, mask, rep)
        return self._done(out, kv_cache)


class LlamaMLP(nn.Module):
    """SwiGLU MLP."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        hs, im = config.hidden_size, config.intermediate_size
        if _use_tp():
            sp = _use_sp(config)
            col = functools.partial(
                ColumnSequenceParallelLinearModule if sp
                else ColumnParallelLinearModule, device=device, dtype=dtype,
                sync_input_grad=False)
            row = RowSequenceParallelLinearModule if sp \
                else RowParallelLinearModule
            self.gate_proj, self.up_proj = col(hs, im), col(hs, im)
            self.down_proj = row(im, hs, device=device, dtype=dtype)
        else:
            self.gate_proj = _linear(hs, im, device, dtype)
            self.up_proj = _linear(hs, im, device, dtype)
            self.down_proj = _linear(im, hs, device, dtype)

    def forward(self, x):
        return self.down_proj(self.mid(x))

    def mid(self, x):
        """The SwiGLU product (``ffn_mid``)."""
        x = _tp_input(x, self.gate_proj)
        return F.silu(self.gate_proj(x)) * self.up_proj(x)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(
            config.hidden_size, config.rms_norm_eps, device, dtype)
        self.self_attn = LlamaAttention(config, device, dtype)
        self.post_attention_layernorm = LlamaRMSNorm(
            config.hidden_size, config.rms_norm_eps, device, dtype)
        self.mlp = LlamaMLP(config, device, dtype)
        if _use_sp(config):
            # applied to the rank's sequence rows: a part of the gradient
            for norm in (self.input_layernorm, self.post_attention_layernorm):
                mark_as_sequence_parallel_parameter(norm.weight)

    def forward(self, x, kv_cache=None, cache_index=None,
                attn_mask_startend_row_indices=None):
        if kv_cache is not None:
            attn, new_cache = self.self_attn(
                self.input_layernorm(x), kv_cache=kv_cache,
                cache_index=cache_index)
            x = x + attn
            x = x + self.mlp(self.post_attention_layernorm(x))
            return x, new_cache
        x = x + self.self_attn(
            self.input_layernorm(x),
            attn_mask_startend_row_indices=attn_mask_startend_row_indices)
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x

    def forward_selective(self, x, attn_mask_startend_row_indices=None,
                          policy=None):
        """The layer as two checkpointed regions that end at attn_core
        and ffn_mid, o_proj, down_proj and the residual adds outside them
        (selective recompute); ``policy`` runs the attention region
        selectively (q, k, v saved under "selective_qkv"). The mask bands
        ride along as a checkpointed input."""
        a = recompute(self._attn_region, x, attn_mask_startend_row_indices,
                      policy=policy)
        x = x + self.self_attn.o_proj(a)
        m = recompute(self._ffn_region, x)
        return x + self.mlp.down_proj(m)

    def _attn_region(self, x, se):
        return self.self_attn.core(self.input_layernorm(x), se)

    def _ffn_region(self, x):
        return self.mlp.mid(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        emb = VocabParallelEmbeddingModule if _use_tp() else nn.Embedding
        self.embed_tokens = emb(config.vocab_size, config.hidden_size,
                                device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps,
                                 device, dtype)
        # fixed at construction, with the layers' module classes
        self.sequence_parallel = _use_sp(config)
        self.sep_group = _sep_group()

    def forward(self, input_ids, kv_caches=None, cache_index=None,
                attn_mask_startend_row_indices=None):
        se = attn_mask_startend_row_indices
        sp = self.sequence_parallel
        if se is not None and sp:
            raise ValueError(
                "attn_mask_startend_row_indices is not supported with "
                "sequence_parallel (the scattered activations would desync "
                "from the full-sequence mask bands)")
        if se is not None and kv_caches is not None:
            raise ValueError(
                "attn_mask_startend_row_indices is not supported with "
                "kv_caches (cached decode applies causal(+window) masks "
                "only)")
        if kv_caches is not None and (sp or self.sep_group is not None):
            raise ValueError(
                "a KV-cache forward takes whole sequences: build the model "
                "without sequence_parallel, on a mesh without sep, to "
                "decode")
        x = self.embed_tokens(input_ids)
        if kv_caches is not None:
            new_caches = []
            for lyr, cache in zip(self.layers, kv_caches):
                x, nc = lyr(x, kv_cache=cache, cache_index=cache_index)
                new_caches.append(nc)
            return self.norm(x), new_caches
        if sp:
            x = ScatterOp.apply(x, self.embed_tokens.group)
        gran = self.config.recompute_granularity \
            if self.config.recompute else None
        policy = save_only_names(*QKV_TAGS) \
            if gran == "selective_qkv" else None
        for lyr in self.layers:
            if gran == "full":
                # the layer reruns in the backward, the mask bands riding
                # along as a checkpointed input
                x = recompute(lyr, x, attn_mask_startend_row_indices=se)
            elif gran is not None:
                x = lyr.forward_selective(x, se, policy)
            else:
                x = lyr(x, attn_mask_startend_row_indices=se)
        if sp:
            x = GatherOp.apply(x, self.embed_tokens.group)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """The causal LM. ``device=None`` builds it on ``cuda`` (raising when
    no GPU is visible); pass ``device="cpu"`` to run the plain versions
    of the kernels on the CPU. Weights are drawn from ``seed`` (normal,
    std ``init_std``; norms at 1) — or loaded afterwards with
    ``load_state_dict`` (see ``bridge.llama_state_from_numpy``)."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0,
                 init_std: float = 0.02):
        super().__init__()
        _check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        dtype = getattr(torch, config.dtype)
        self.llama = LlamaModel(config, self.device, dtype)
        if config.tie_word_embeddings:
            self.lm_head = None
        elif _use_tp():
            self.lm_head = ColumnParallelLinearModule(
                config.hidden_size, config.vocab_size, gather_output=True,
                device=self.device, dtype=dtype)
        else:
            self.lm_head = _linear(config.hidden_size, config.vocab_size,
                                   self.device, dtype)
        self.reset_parameters(seed, init_std)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0, init_std: float = 0.02):
        """Norms at 1, every other parameter normal(0, ``init_std``) from
        one generator in parameter order; a tensor-parallel parameter is
        drawn at its global shape and sliced to this rank's shard."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        modules = dict(self.named_modules())
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
                continue
            mname, _, pname = name.rpartition(".")
            m = modules[mname]
            shape = global_shape(m, pname)
            if list(shape) == list(p.shape):
                p.normal_(0.0, init_std, generator=gen)
            else:
                full = torch.empty(shape, device=p.device, dtype=p.dtype)
                p.copy_(shard_of(m, pname, full.normal_(
                    0.0, init_std, generator=gen)))

    def _vocab_group(self):
        """The mp group the head's vocabulary is split over (None
        unsplit)."""
        m = self.lm_head if self.lm_head is not None \
            else self.llama.embed_tokens
        g = getattr(m, "group", None)
        return g if g is not None and g.nranks > 1 else None

    def _head(self, h):
        """The LM head module (a ``torch.nn.Linear``, or what
        ``quantize_for_inference`` put in its place); tied, the embedding
        weight (a vocabulary shard's logits gathered under TP)."""
        if self.lm_head is not None:
            return self.lm_head(h)
        g = self._vocab_group()
        if g is None:
            return torch.nn.functional.linear(h,
                                              self.llama.embed_tokens.weight)
        local = torch.nn.functional.linear(_c_identity(h, group=g),
                                           self.llama.embed_tokens.weight)
        return _c_concat(local, group=g)

    def forward(self, input_ids, labels=None,
                attn_mask_startend_row_indices=None, kv_caches=None,
                cache_index=None):
        """Logits [b, s, vocab]; with ``kv_caches`` also the updated
        caches. With ``labels`` and ``config.fused_linear_ce`` the f32 mean
        LM loss of the chunked fused head instead (labels are otherwise
        ignored, as in the JAX package). ``attn_mask_startend_row_indices``:
        a flashmask mask ([b|1, h_se, s, C] int) for every layer."""
        se = attn_mask_startend_row_indices
        if kv_caches is not None and se is not None:
            raise ValueError(
                "attn_mask_startend_row_indices is not supported with "
                "kv_caches (cached decode applies causal(+window) masks "
                "only — packed multi-document contexts must be decoded as "
                "separate requests)")
        fused = labels is not None and self.config.fused_linear_ce
        if self.llama.sep_group is not None and kv_caches is None \
                and not fused and torch.is_grad_enabled():
            raise ValueError(
                "a model built for a sequence split over sep trains through "
                "its fused loss (labels, with fused_linear_ce=True): a loss "
                "on a rank's chunk of the logits is not the sequence's "
                "(take logits under torch.no_grad())")
        input_ids = torch.as_tensor(input_ids, device=self.device)
        if kv_caches is not None:
            h, new_caches = self.llama(input_ids, kv_caches=kv_caches,
                                       cache_index=cache_index)
            return self._head(h), new_caches
        if se is not None:
            se = torch.as_tensor(se, device=self.device)
        h = self.llama(input_ids, attn_mask_startend_row_indices=se)
        if fused:
            # [H, V] (paddle Linear layout); tied: the embedding transposed
            w = (self.lm_head.weight if self.lm_head is not None
                 else self.llama.embed_tokens.weight).t()
            if not w.is_floating_point():
                raise ValueError(
                    "the fused linear cross entropy needs a float LM head, "
                    f"but lm_head is a {type(self.lm_head).__name__} holding "
                    f"{w.dtype} weights (converted by quantize_for_inference)"
                    ": training a quantized model is not supported")
            return fused_linear_cross_entropy(
                h, w, torch.as_tensor(labels, device=self.device),
                n_chunks=self.config.fused_ce_chunks,
                group=self._vocab_group(), seq_group=self.llama.sep_group)
        return self._head(h)

    def zero3_entry_modules(self):
        """The module whose weight ``forward`` reads without calling it
        (the fused loss's and the tied head's weight): ZeRO-3 gathers it
        for the whole forward."""
        return [self.lm_head if self.lm_head is not None
                else self.llama.embed_tokens]

    def serving_spec(self):
        """Engine geometry probe (``Engine`` reads it through
        ``serving_model_spec``): the decoder's KV-cache geometry as a
        plain dict (plus ``num_heads``, which the CUDA decode kernel's
        shared-memory check needs)."""
        c = self.config
        return {
            "kind": "decoder",
            "num_layers": c.num_hidden_layers,
            "kv_heads": c.num_key_value_heads,
            "num_heads": c.num_attention_heads,
            "head_dim": c.hidden_size // c.num_attention_heads,
            "max_context": c.max_position_embeddings,
            "vocab_size": c.vocab_size,
        }


class _TiedHead:
    """The tied LM head of ``build_llama_pipe`` (JAX ``_tied_head`` :776):
    logits = h E^T from the shared embedding (a vocabulary shard's
    logits gathered under TP). With ``fused_ce_chunks`` it also offers
    ``pipe_loss(embed, h, labels)``, the fused chunked LM loss, which the
    pipeline's last stage takes in place of logits + loss."""

    def __init__(self, fused_ce_chunks=None):
        if fused_ce_chunks:
            self.chunks = int(fused_ce_chunks)
            self.pipe_loss = self._loss

    @staticmethod
    def _group(embed):
        g = getattr(embed, "group", None)
        return g if g is not None and g.nranks > 1 else None

    def __call__(self, embed, h):
        g = self._group(embed)
        if g is None:
            return torch.nn.functional.linear(h, embed.weight)
        return _c_concat(torch.nn.functional.linear(
            _c_identity(h, group=g), embed.weight), group=g)

    def _loss(self, embed, h, labels):
        return fused_linear_cross_entropy(h, embed.weight.t(), labels,
                                          n_chunks=self.chunks,
                                          group=self._group(embed))


def _head_loss(head, chunks, h, labels):
    """The untied head's fused chunked LM loss (``pipe_loss``)."""
    g = getattr(head, "group", None)
    return fused_linear_cross_entropy(
        h, head.weight.t(), labels, n_chunks=chunks,
        group=g if g is not None and g.nranks > 1 else None)


def build_llama_pipe(config: LlamaConfig, num_stages=None, loss_fn=None,
                     device=None, seed: int = 0, init_std: float = 0.02,
                     seg_method="uniform", num_virtual_pipeline_stages=None):
    """``LlamaForCausalLM`` as a ``PipelineLayer`` (JAX :786): [embedding]
    + num_hidden_layers ``LlamaDecoderLayer`` blocks + [final RMSNorm, LM
    head], the blocks the run ``PipelineParallel`` chunks over the stages
    (the embedding joins stage 0, the norm and head the last).

    The modules are built in ``LlamaForCausalLM``'s order and drawn as
    ``reset_parameters`` draws them (one generator from ``seed``, in
    parameter order; norms at 1; a TP parameter at its global shape,
    sliced), so a pipe and the causal LM from one seed hold the same
    weights. ``tie_word_embeddings`` maps to a ``SharedLayerDesc`` pair
    (the embedding's weight on the first and the last stage, its gradient
    summed between them); ``recompute`` to ``recompute_interval``; under
    mp > 1 the embedding is vocabulary-parallel and the head a
    ``ColumnParallelLinearModule`` gathering its output. With
    ``fused_linear_ce`` (and no ``loss_fn`` given) the head offers
    ``pipe_loss``, the fused chunked loss the last stage then computes
    instead of logits + ``CrossEntropyLoss`` (the JAX pipe always takes
    the latter). ``device`` as ``LlamaForCausalLM``'s: ``cuda`` unless
    ``device="cpu"``. ``seg_method`` and ``num_virtual_pipeline_stages``
    go to the ``PipelineLayer``."""
    from ...distributed.fleet.meta_parallel import (PipelineLayer,
                                                    SharedLayerDesc)
    from ...nn._modules import CrossEntropyLoss
    c = config
    _check_supported(c)
    dev = resolve_device(device)
    dtype = getattr(torch, c.dtype)
    emb = VocabParallelEmbeddingModule if _use_tp() else nn.Embedding
    # the embedding first either way (the causal LM's draw order)
    embed = emb(c.vocab_size, c.hidden_size, device=dev, dtype=dtype)
    fused = c.fused_ce_chunks if (c.fused_linear_ce and loss_fn is None) \
        else None
    first = SharedLayerDesc("tok_embed", lambda: embed) \
        if c.tie_word_embeddings else embed
    blocks = [LlamaDecoderLayer(c, dev, dtype)
              for _ in range(c.num_hidden_layers)]
    norm = LlamaRMSNorm(c.hidden_size, c.rms_norm_eps, dev, dtype)
    if c.tie_word_embeddings:
        head = SharedLayerDesc("tok_embed", lambda: embed,
                               forward_func=_TiedHead(fused))
    else:
        head = ColumnParallelLinearModule(
            c.hidden_size, c.vocab_size, gather_output=True, device=dev,
            dtype=dtype) if _use_tp() else _linear(c.hidden_size,
                                                   c.vocab_size, dev, dtype)
        if fused:
            head.pipe_loss = functools.partial(_head_loss, head, fused)
    pipe = PipelineLayer([first] + blocks + [norm, head],
                         num_stages=num_stages,
                         recompute_interval=1 if c.recompute else 0,
                         loss_fn=loss_fn or CrossEntropyLoss(),
                         seg_method=seg_method,
                         num_virtual_pipeline_stages=(
                             num_virtual_pipeline_stages))
    pipe.config = c
    _draw_pipe(pipe, seed, init_std, dev)
    return pipe


@torch.no_grad()
def _draw_pipe(pipe, seed, init_std, device):
    """``LlamaForCausalLM.reset_parameters`` over the pipe's parameters
    (the same order)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    modules = dict(pipe.named_modules())
    for name, p in pipe.named_parameters():
        mname, _, pname = name.rpartition(".")
        m = modules[mname]
        if isinstance(m, LlamaRMSNorm):
            p.fill_(1.0)
            continue
        shape = global_shape(m, pname)
        if list(shape) == list(p.shape):
            p.normal_(0.0, init_std, generator=gen)
        else:
            full = torch.empty(shape, device=p.device, dtype=p.dtype)
            p.copy_(shard_of(m, pname, full.normal_(
                0.0, init_std, generator=gen)))


def llama_flops_per_token(config: LlamaConfig) -> float:
    """Approximate training FLOPs per token: 6 N over the embedding, head
    and decoder matmul weights (``llama_flops_per_token``, :837)."""
    n = (config.vocab_size * config.hidden_size * 2
         + config.num_hidden_layers * (
             4 * config.hidden_size * config.hidden_size
             + 3 * config.hidden_size * config.intermediate_size))
    return 6.0 * n
