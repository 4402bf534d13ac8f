"""Fused and decode ops (counterparts of
``paddle_tpu/incubate/nn/functional/__init__.py``):
``fused_rotary_position_embedding`` (:92), ``fused_linear_cross_entropy``
(:173), the decode-op surface — ``masked_multihead_attention``
(:554), ``variable_length_memory_efficient_attention`` (:657),
``paged_attention`` / ``paged_write`` / ``paged_quant_write`` (:689-724),
``block_multihead_attention`` (:725, refused as there) and
``blha_get_max_len`` (:742) — and the fused-op batch: ``fused_moe``
(:15), ``fused_rms_norm`` (:68), ``fused_linear`` (:234),
``fused_matmul_bias`` (:246), ``fused_linear_activation`` (:262),
``fused_bias_act`` (:271), ``fused_dropout_add`` (:295),
``fused_layer_norm`` (:317), ``fused_bias_dropout_residual_layer_norm``
(:346), ``fused_feedforward`` (:383), ``fused_multi_head_attention``
(:452) and ``fused_multi_transformer`` (:543, refused as there).

Every op follows ``nn.functional``'s rule: surface Tensors in and out,
or raw torch tensors in and out (``core.dispatch.surface``). The
fused-op batch is plain PyTorch, as the JAX ops are plain ``jnp``
compositions (no Pallas kernel in any of them). ``fused_moe`` runs every expert on every token, as
the JAX one does; it is not the grouped-FFN kernel of ``MoELayer``.
Their dropouts draw f32 uniforms from the port's generator of the
input's device (``core.random``): the JAX threefry masks cannot be
reproduced, so only the rate and the scaling agree. "gelu" is the tanh
approximation, ``jax.nn.gelu``'s default.

``paged_attention`` runs ``kernels.paged_attention.paged_decode``: the
CUDA paged-decode kernel on a CUDA tensor, its plain version on a CPU
tensor. The writes (``paged_write``, ``paged_quant_write``,
``masked_multihead_attention``'s cache) update the caches IN PLACE and
return the same tensors (the caller's own surface Tensors when it passed
them), where the JAX package returns new arrays.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core import random as random_mod
from ...core.dispatch import surface
from ...nn.functional.activation import swiglu  # noqa: F401
from ...nn.functional.common import dropout
from ...nn.functional.norm import rms_norm


def _rope_tables(d, position_ids, s_len, dtype, device, neox=True):
    """sin/cos tables [b|1, s, 1, d] in ``dtype`` in the layout of the
    rotary style: neox ``[θ0..θd/2-1, θ0..θd/2-1]``, interleaved
    ``[θ0, θ0, θ1, θ1, ...]``. Angles in f32 at base 10000,
    ``position_ids`` [s] or [b, s] (None = arange)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=device) / d))
    if position_ids is None:
        pos_idx = torch.arange(s_len, device=device)
    else:
        pos_idx = torch.as_tensor(position_ids, device=device)
    pos = pos_idx.to(torch.float32)[..., :, None] * inv      # [..., s, d/2]
    if neox:
        s_a = torch.cat([torch.sin(pos), torch.sin(pos)], dim=-1)
        c_a = torch.cat([torch.cos(pos), torch.cos(pos)], dim=-1)
    else:
        s_a = torch.sin(pos).repeat_interleave(2, dim=-1)
        c_a = torch.cos(pos).repeat_interleave(2, dim=-1)
    s_a = s_a.to(dtype)[..., :, None, :]
    c_a = c_a.to(dtype)[..., :, None, :]
    if s_a.dim() == 3:                       # shared positions: batch dim
        s_a, c_a = s_a[None], c_a[None]
    return s_a, c_a


def _gather_table(tab, position_ids, dtype, device):
    """A user sin/cos table ([s_max, d], any leading ones) indexed by
    ``position_ids`` ([s] or [b, s]) -> [b|1, s, 1, d] in ``dtype``."""
    t = torch.as_tensor(tab, device=device)
    t = t.reshape(t.shape[-2], t.shape[-1])
    g = t[torch.as_tensor(position_ids, device=device).long()]
    g = g.to(dtype)[..., :, None, :]
    return g[None] if g.dim() == 3 else g


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """RoPE on [b, s, h, d] tensors. Returns the rotated (q, k, v) with
    None for absent inputs; v is rotated like the others when given, as
    in the JAX package.

    Neox style rotates halves (``[-x2, x1]``), the interleaved style
    (``use_neox_rotary_style=False``) rotates pairs (``(-x1, x0), (-x3,
    x2), ...``). The angles are computed at base 10000 from
    ``position_ids`` ([s] or [b, s]; None = arange), unless both ``sin``
    and ``cos`` are given: user tables, used as they are (broadcast
    against [b, s, h, d]) or, with ``position_ids``, as [s_max, d]
    tables indexed by them."""
    return surface("fused_rotary_position_embedding",
                   lambda *a: _rope(*a, use_neox_rotary_style),
                   [q, k, v, sin, cos, position_ids])


def _rope(q, k, v, sin, cos, position_ids, neox):
    user = sin is not None and cos is not None

    def make(t):
        if t is None:
            return None
        d = t.shape[-1]
        if not user:
            s_a, c_a = _rope_tables(d, position_ids, t.shape[1], t.dtype,
                                    t.device, neox)
        elif position_ids is None:
            s_a, c_a = (torch.as_tensor(a, device=t.device)
                        for a in (sin, cos))
        else:
            s_a, c_a = (_gather_table(a, position_ids, t.dtype, t.device)
                        for a in (sin, cos))
        if neox:
            t1, t2 = t[..., : d // 2], t[..., d // 2:]
            rot = torch.cat([-t2, t1], dim=-1)
        else:
            rot = torch.stack([-t[..., 1::2], t[..., 0::2]],
                              dim=-1).reshape(t.shape)
        return t * c_a + rot * s_a

    return tuple(make(t) for t in (q, k, v))


def _chunk_stats(hc, w, group):
    """f32 logits of one row chunk (over a group, this rank's vocabulary
    columns) and their logsumexp over the whole vocabulary (:216-221):
    over a group of n > 1 two all-reduces, the row max and the sum of
    exponentials, ``_c_softmax_with_cross_entropy``'s."""
    logits = (hc @ w).float()
    if group is None:
        return logits, torch.logsumexp(logits, dim=-1)
    from ...distributed.communication import collectives as C
    m = logits.max(dim=-1).values
    C.all_reduce(m, op=C.ReduceOp.MAX, group=group)
    s = torch.exp(logits - m[:, None]).sum(dim=-1)
    C.all_reduce(s, group=group)
    return logits, m + torch.log(s)


def _in_shard(lc, start, width):
    """Each label's column in the vocabulary shard [start, start +
    width), and the mask of the labels that fall in it."""
    local = lc - start
    inside = (local >= 0) & (local < width)
    return torch.where(inside, local, 0), inside


class _FusedLinearCE(torch.autograd.Function):
    """Mean NLL of ``softmax(h @ w)`` over row chunks. The forward keeps
    no logits, only each row's logsumexp; the backward recomputes each
    chunk's logits, so one [rows / chunks, V] f32 tile is alive at a time
    (the JAX package's ``jax.checkpoint`` over the scan body, :226).

    ``group`` (None, or an mp group of n > 1): ``w`` is then this rank's
    vocabulary shard [H, V / n], columns [rank * V / n, (rank + 1) * V /
    n); each chunk's logits stay a shard, the label's logit takes a third
    all-reduce, and the backward all-reduces the hidden's gradient (each
    rank holds a part). ``hs`` and the labels are the same on every
    rank.

    ``seq_group`` (None, or a sep group of n > 1): the rows are this
    rank's chunk of the sequence; the sums and the valid counts are
    all-reduced over it, so the loss is the whole sequence's mean on every
    rank, and the backward gives this rank's rows their part of its
    gradient (the ranks' gradients are then summed over sep: the policy
    of ``hybrid_parallel_optimizer``)."""

    @staticmethod
    def forward(ctx, hs, w, ls, ignore_index, chunks, group, seq_group):
        n = 1 if group is None else group.nranks
        start = 0 if group is None else group.rank * w.shape[1]
        tot = torch.zeros((), dtype=torch.float32, device=hs.device)
        cnt = torch.zeros((), dtype=torch.float32, device=hs.device)
        lses = []
        for hc, lc in zip(hs.chunk(chunks), ls.chunk(chunks)):
            logits, lse = _chunk_stats(hc, w, group)
            safe, inside = _in_shard(lc, start, w.shape[1])
            picked = torch.where(
                inside, logits.gather(-1, safe[:, None])[:, 0], 0.0)
            if group is not None:
                from ...distributed.communication import collectives as C
                C.all_reduce(picked, group=group)
            # labels outside [0, V) are invalid, not clipped to a class
            valid = (lc != ignore_index) & (lc >= 0) & \
                (lc < w.shape[1] * n)
            tot = tot + torch.where(valid, lse - picked, 0.0).sum()
            cnt = cnt + valid.float().sum()
            lses.append(lse)
            del logits
        if seq_group is not None:
            from ...distributed.communication import collectives as C
            both = torch.stack([tot, cnt])
            C.all_reduce(both, group=seq_group)
            tot, cnt = both[0], both[1]
        denom = torch.clamp(cnt, min=1.0)
        ctx.save_for_backward(hs, w, ls, denom, torch.cat(lses))
        ctx.ignore_index, ctx.chunks, ctx.group = ignore_index, chunks, group
        ctx.start, ctx.vocab = start, w.shape[1] * n
        return tot / denom

    @staticmethod
    def backward(ctx, g):
        hs, w, ls, denom, lse_all = ctx.saved_tensors
        coef = g.float() / denom
        dh = torch.empty_like(hs)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        rows = 0
        for hc, lc in zip(hs.chunk(ctx.chunks), ls.chunk(ctx.chunks)):
            n = hc.shape[0]
            lse = lse_all[rows:rows + n]
            logits = (hc @ w).float()
            safe, inside = _in_shard(lc, ctx.start, w.shape[1])
            # d(lse - picked)/dlogits = softmax - onehot, on valid rows
            dlog = torch.exp(logits.sub_(lse[:, None]))
            dlog.scatter_add_(-1, safe[:, None], -inside.float()[:, None])
            valid = (lc != ctx.ignore_index) & (lc >= 0) & (lc < ctx.vocab)
            dlog.mul_((valid.float() * coef)[:, None])
            # the f32 logits' cotangent reaches the matmul in its dtype,
            # as the autodiff of astype does
            dlog = dlog.to(w.dtype)
            dh[rows:rows + n] = dlog @ w.t()
            dw += (hc.t() @ dlog).float()
            rows += n
            del logits, dlog
        if ctx.group is not None:
            from ...distributed.communication import collectives as C
            C.all_reduce(dh, group=ctx.group)
        return dh, dw.to(w.dtype), None, None, None, None, None


def fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100,
                               n_chunks=8, name=None, group=None,
                               seq_group=None):
    """Fused lm-head matmul + softmax cross entropy, chunked over rows
    (counterpart of ``fused_linear_cross_entropy``,
    ``paddle_tpu/incubate/nn/functional/__init__.py:173``).

    hidden [..., H]; weight [H, V] (the paddle Linear layout: pass
    ``lm_head.weight.t()`` or a tied ``embed_tokens.weight.t()``);
    labels [...] int. Returns the f32 mean NLL over valid labels (not
    ``ignore_index``, inside [0, V)). The rows are padded with ignored
    rows to a multiple of the chunk count; peak memory holds one
    [rows / chunks, V] f32 logits tile in the forward and in the
    backward. The two products per chunk are plain matmuls
    (``torch.matmul``), as the JAX package leaves them to XLA.
    Gradients flow to hidden and weight.

    ``group``: a model-parallel group of n ranks over which ``weight`` is
    split by vocabulary (this rank's [H, V / n] columns); the loss is then
    the same as the unsplit one's, with no [rows, V] logits gathered.

    ``seq_group``: a sep group over which the sequence is split (this
    rank's rows are its chunk): the loss is the mean over every rank's
    valid labels, its gradient this rank's rows' part
    (``_FusedLinearCE``)."""
    if int(n_chunks) < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    return surface("fused_linear_cross_entropy", lambda h, w, lab: _fused_ce(
        h, w, lab, ignore_index, n_chunks, group, seq_group),
        [hidden, weight, labels])


def _fused_ce(hidden, weight, labels, ignore_index, n_chunks, group,
              seq_group):
    hs = hidden.reshape(-1, hidden.shape[-1])
    ls = torch.as_tensor(labels, device=hidden.device).reshape(-1).long()
    n = hs.shape[0]
    chunks = int(min(n_chunks, n))
    if n % chunks:
        # pad with ignored rows so the chunking survives ragged batches
        pad = chunks - n % chunks
        hs = torch.cat([hs, hs.new_zeros(pad, hs.shape[-1])])
        ls = torch.cat([ls, ls.new_full((pad,), ignore_index)])
    if group is not None and group.nranks == 1:
        group = None
    if seq_group is not None and seq_group.nranks == 1:
        seq_group = None
    return _FusedLinearCE.apply(hs, weight, ls, int(ignore_index), chunks,
                                group, seq_group)


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               qkv_out_scale=None, out_shift=None,
                               out_smooth=None, seq_len=1,
                               rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """Single-token decode attention against a dense KV cache, the JAX
    package's supported subset (:554): x [b, 3*h*d] packed qkv for one
    step, cache_kv [2, b, h, max_seq, d], optional bias [3, h, d],
    optional additive src_mask [b, 1, 1, L], sequence_lengths [b, 1] =
    each sequence's write position (default: src_mask's length - 1).
    Returns (out [b, h*d], cache_kv), the cache written in place. Beam
    offsets, in-kernel rotary and the int8-quant arguments are refused as
    in the JAX package. The capacity check of ``sequence_lengths`` reads
    the positions on the host (a sync). A surface ``cache_kv`` comes back
    as the same Tensor."""
    if cum_offsets is not None or beam_cache_offset is not None:
        raise NotImplementedError(
            "cum_offsets/beam_cache_offset are CUDA-serving specifics")
    if rotary_tensor is not None or rotary_emb_dims:
        raise NotImplementedError(
            "apply rotary embeddings before the call (fused_rotary_"
            "position_embedding); the in-kernel rotary path is not carried")
    if qkv_out_scale is not None or out_shift is not None \
            or out_smooth is not None or (out_scale is not None
                                          and out_scale > 0):
        raise NotImplementedError(
            "int8-quant scales are CUDA-kernel specifics")
    if cache_kv is None:
        raise ValueError("masked_multihead_attention requires cache_kv")
    if src_mask is None and sequence_lengths is None:
        raise ValueError(
            "pass sequence_lengths (write positions) or src_mask "
            "(whose last dim implies position = L - 1)")
    out = surface("masked_multihead_attention", _mmha,
                  [x, cache_kv, bias, src_mask, sequence_lengths])
    return _in_place(out, {1: cache_kv})


def _in_place(out, given):
    """An in-place op's result with each written cache or pool (at the
    output positions of ``given``) handed back as the object the caller
    passed: the same surface Tensor, not a new wrapper of its storage."""
    out = list(out)
    for i, obj in given.items():
        out[i] = obj
    return tuple(out)


def _mmha(x, cache_kv, bias, src_mask, sequence_lengths):
    _, b, h, max_seq, d = cache_kv.shape
    dev = cache_kv.device
    if sequence_lengths is not None:
        pos = torch.as_tensor(sequence_lengths, device=dev).reshape(b).long()
        pmax = int(pos.max())
        if pmax >= max_seq:
            # an out-of-range write would be dropped while the mask
            # unmasks every slot: fail loudly
            raise ValueError(
                f"sequence_lengths position {pmax} exceeds the cache's "
                f"max_seq_len {max_seq}")
    else:
        if src_mask.shape[-1] > max_seq:
            raise ValueError(
                f"src_mask length {src_mask.shape[-1]} exceeds the "
                f"cache's max_seq_len {max_seq}")
        pos = torch.full((b,), src_mask.shape[-1] - 1, dtype=torch.long,
                         device=dev)
    qkv = x.reshape(b, 3, h, d).float()
    if bias is not None:
        qkv = qkv + torch.as_tensor(bias, device=dev).float()[None]
    qa, ka, va = qkv.unbind(1)                                # [b, h, d]
    bi = torch.arange(b, device=dev)
    cache_kv[0, bi, :, pos] = ka.to(cache_kv.dtype)
    cache_kv[1, bi, :, pos] = va.to(cache_kv.dtype)
    logits = torch.einsum("bhd,bhLd->bhL", qa, cache_kv[0].float())
    logits = logits / math.sqrt(d)
    valid = torch.arange(max_seq, device=dev)[None, :] <= pos[:, None]
    logits = torch.where(valid[:, None, :], logits,
                         torch.full_like(logits, -1e30))
    if src_mask is not None:
        lm = torch.as_tensor(src_mask, device=dev).reshape(b, 1, -1).float()
        logits[..., :lm.shape[-1]] += lm
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhL,bhLd->bhd", p, cache_kv[1].float())
    return out.reshape(b, h * d).to(x.dtype), cache_kv


def variable_length_memory_efficient_attention(query, key, value,
                                               seq_lens, kv_seq_lens,
                                               mask=None, scale=None,
                                               causal=False, name=None):
    """Attention with per-sequence lengths (:657): q [B, H, S, D], k / v
    [B, H, T, D]; keys at or past ``kv_seq_lens`` are masked, query rows
    at or past ``seq_lens`` give zeros; ``causal`` aligns the queries to
    the last keys (query s sees keys <= s + T - S); ``mask`` is added to
    the scores. Computed in the inputs' dtype."""
    return surface("varlen_mem_efficient_attention",
                   lambda *a: _varlen_attention(*a, scale, causal),
                   [query, key, value, seq_lens, kv_seq_lens, mask])


def _varlen_attention(query, key, value, seq_lens, kv_seq_lens, mask,
                      scale, causal):
    B, H, S, D = query.shape
    T = key.shape[2]
    dev = query.device
    scl = scale if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bhsd,bhtd->bhst", query, key) * scl
    kvl = torch.as_tensor(kv_seq_lens, device=dev)
    kmask = torch.arange(T, device=dev)[None, :] < kvl.reshape(-1, 1)
    neg = torch.full_like(scores, -1e30)
    scores = torch.where(kmask[:, None, None, :], scores, neg)
    if causal:
        cm = (torch.arange(S, device=dev)[:, None] + (T - S)
              >= torch.arange(T, device=dev)[None, :])
        scores = torch.where(cm[None, None], scores, neg)
    if mask is not None:
        scores = scores + torch.as_tensor(mask, device=dev)
    out = torch.einsum("bhst,bhtd->bhsd", torch.softmax(scores, dim=-1),
                       value)
    sl = torch.as_tensor(seq_lens, device=dev)
    qmask = torch.arange(S, device=dev)[None, :] < sl.reshape(-1, 1)
    return out * qmask[:, None, :, None]


def paged_attention(query, k_cache, v_cache, block_tables, context_lens,
                    scale=None, k_scale=None, v_scale=None):
    """One decode step against a paged KV cache (:689; the capability
    behind the reference's block_multihead_attention): query [b, h, d],
    page pools [num_blocks, h_kv, block_size, d], block_tables [b,
    max_blocks], context_lens [b] (0 = a dead slot, zeros out); pass the
    k_scale / v_scale pools [num_blocks, h_kv, block_size] of an int8
    pool. Runs ``kernels.paged_attention.paged_decode``: the CUDA
    kernel on the card, its plain version on the CPU."""
    from ...kernels.paged_attention import paged_decode
    return surface("paged_attention",
                   lambda q, kc, vc, bt, cl, ks, vs: paged_decode(
                       q, kc, vc, bt, cl, scale=scale, k_scale=ks,
                       v_scale=vs),
                   [query, k_cache, v_cache, block_tables, context_lens,
                    k_scale, v_scale])


def paged_write(key, value, k_cache, v_cache, block_tables, positions):
    """Append one token's k / v per sequence ([b, h_kv, d], or a chunk
    [b, s, h_kv, d]) at ``positions`` [b] into the paged pools, in place
    (the write half of the paged-decode loop). Returns the pools: the
    caller's own surface Tensors when it passed them."""
    from ...kernels.paged_attention import paged_write_arrays

    def body(k, v, kc, vc, bt, pos):
        return paged_write_arrays(k, v, kc, vc, bt,
                                  torch.as_tensor(pos, device=kc.device))
    out = surface("paged_write", body,
                  [key, value, k_cache, v_cache, block_tables, positions])
    return _in_place(out, {0: k_cache, 1: v_cache})


def paged_quant_write(key, value, k_cache, v_cache, k_scale, v_scale,
                      block_tables, positions):
    """paged_write for an int8 page pool: quantizes the float chunk per
    (token, kv_head) and writes the values and the per-slot scales, in
    place. Returns the four pools (the caller's surface Tensors when it
    passed them)."""
    from ...kernels.paged_attention import paged_write_quant_arrays

    def body(k, v, kc, vc, ks, vs, bt, pos):
        return paged_write_quant_arrays(
            k, v, kc, vc, ks, vs, bt, torch.as_tensor(pos, device=kc.device))
    out = surface("paged_quant_write", body,
                  [key, value, k_cache, v_cache, k_scale, v_scale,
                   block_tables, positions])
    return _in_place(out, {0: k_cache, 1: v_cache, 2: k_scale, 3: v_scale})


def block_multihead_attention(*args, **kwargs):
    """(reference: block_multihead_attention, the paged-KV CUDA serving
    entry with packed qkv rows, cum offsets and rope tables). Refused as
    in the JAX package (:725): its capability is ``paged_attention`` +
    ``paged_write`` here, or ``text.generate(cache_impl="paged")``."""
    raise NotImplementedError(
        "use paddle_tpu_torch.incubate.nn.functional.paged_attention (+ "
        "paged_write / paged_quant_write), or paddle_tpu_torch.text."
        "generate(cache_impl='paged') for the CUDA paged-decode path — "
        "this entry's serving argument layout (packed qkv rows, "
        "cum_offsets, rope tables) is not carried")


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size=None,
                     name=None):
    """The largest encoder and decoder lengths, each as a [1] tensor
    (:742); read on the host."""
    enc = torch.as_tensor(seq_lens_encoder)
    dec = torch.as_tensor(seq_lens_decoder)
    return (torch.tensor([int(enc.max())], device=enc.device),
            torch.tensor([int(dec.max())], device=dec.device))


# -- the fused-op batch -------------------------------------------------------

def _gelu(a):
    return TF.gelu(a, approximate="tanh")


def _relu(a):
    return torch.clamp(a, min=0)


def _drop(a, rate, training, mode):
    """``nn.functional.dropout`` of a raw tensor, its mask from the port's
    generator of a's device."""
    return dropout(a, rate, training=training, mode=mode,
                   generator=random_mod.generator(a.device))


def _ln(a, scale, bias, eps, axes=(-1,)):
    """LayerNorm over ``axes`` with the population variance, as the JAX
    compositions write it ((a - mean) / sqrt(var + eps))."""
    mean = a.mean(dim=axes, keepdim=True)
    var = a.var(dim=axes, keepdim=True, unbiased=False)
    out = (a - mean) / torch.sqrt(var + eps)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


def _fused_moe(xx, gl, w1, w2, b1, b2, moe_topk, norm_topk_prob):
    # ties to the lowest index, as jax.lax.top_k (imported here: the text
    # package imports this module through its models)
    from ...text.generation import _top_k_first
    probs = torch.softmax(gl.float(), dim=-1)
    topv, topi = _top_k_first(probs, moe_topk)             # [b, s, k]
    if norm_topk_prob:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    h = torch.einsum("bsd,edf->besf", xx, w1)
    if b1 is not None:
        h = h + b1.reshape(1, w1.shape[0], 1, -1)
    a, g = h.chunk(2, dim=-1)
    y = torch.einsum("besf,efd->besd", TF.silu(a) * g, w2)
    if b2 is not None:
        y = y + b2.reshape(1, w2.shape[0], 1, -1)
    comb = (TF.one_hot(topi, gl.shape[-1]).to(topv.dtype)
            * topv[..., None]).sum(dim=-2)                  # [b, s, E]
    return torch.einsum("bse,besd->bsd", comb.to(y.dtype), y)


def fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias=None,
              ffn1_scale=None, ffn2_bias=None, ffn2_scale=None,
              quant_method="None", moe_topk=2, norm_topk_prob=True):
    """Mixture-of-experts SwiGLU FFN, every expert on every token (:15):
    x [b, s, d]; ``gate_weight`` the per-token gate logits [b, s, E];
    ``ffn1_weight`` [E, d, 2 dff] (the gate and up halves), ``ffn2_weight``
    [E, dff, d], biases [E, 1, 2 dff] / [E, 1, d]. The top-k gate
    probabilities (renormalised with ``norm_topk_prob``) combine the
    experts' outputs. Quantized experts are refused, as in the JAX
    package."""
    if quant_method not in (None, "None", "none"):
        raise NotImplementedError("fused_moe quant_method is not supported")
    if ffn1_scale is not None or ffn2_scale is not None:
        raise NotImplementedError(
            "fused_moe dequantization scales require a quant_method, "
            "which is not supported")
    return surface("fused_moe", lambda *a: _fused_moe(
        *a, moe_topk, norm_topk_prob),
        [x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias, ffn2_bias])


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1):
    """RMS norm over the dims from ``begin_norm_axis`` on (:68)."""
    ndim = len(x.shape)
    ax = begin_norm_axis % ndim
    if ax == ndim - 1:
        out = rms_norm(x, norm_weight, epsilon=epsilon)
        return out + norm_bias if norm_bias is not None else out
    axes = tuple(range(ax, ndim))

    def fn(a, w, b):
        ms = a.float().square().mean(dim=axes, keepdim=True)
        out = a * torch.reciprocal(torch.sqrt(ms + epsilon)).to(a.dtype) * w
        return out if b is None else out + b
    return surface("fused_rms_norm", fn, [x, norm_weight, norm_bias])


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ W (+ b); W [in, out], or [out, in] with ``transpose_weight``
    (:234)."""
    def fn(a, w, b):
        out = a @ (w.t() if transpose_weight else w)
        return out if b is None else out + b
    return surface("fused_linear", fn, [x, weight, bias])


def fused_matmul_bias(x, y, bias=None, transpose_x=False,
                      transpose_y=False, name=None):
    """op(x) @ op(y) (+ bias), op a transpose of the last two axes when
    asked (:246)."""
    def fn(a, b, c):
        if transpose_x:
            a = a.transpose(-2, -1)
        if transpose_y:
            b = b.transpose(-2, -1)
        out = a @ b
        return out if c is None else out + c
    return surface("fused_matmul_bias", fn, [x, y, bias])


_LINEAR_ACTS = {"gelu": _gelu, "relu": _relu, "none": lambda a: a}


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu", name=None):
    """act(fused_matmul_bias(...)), act one of gelu, relu, none (:262)."""
    out = fused_matmul_bias(x, y, bias, trans_x, trans_y)
    return surface("fused_act", _LINEAR_ACTS[activation], [out])


def _gated(act):
    def fn(v):
        u, g = v.chunk(2, dim=-1)
        return act(u) * g
    return fn


_BIAS_ACTS = {"gelu": _gelu, "relu": _relu, "swiglu": _gated(TF.silu),
              "geglu": _gated(_gelu)}


def fused_bias_act(x, bias=None, dequant_scales=None, shift=None,
                   smooth=None, act_method="gelu", compute_dtype="default",
                   quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                   quant_min_bound=0, name=None):
    """act(x + bias), act one of gelu, relu, swiglu, geglu (:271); the
    quantization arguments are taken and ignored, as in the JAX
    package."""
    act = _BIAS_ACTS[act_method]
    return surface("fused_bias_act",
                   lambda a, b: act(a if b is None else a + b), [x, bias])


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """dropout(x) + y (:295)."""
    return surface("fused_dropout_add",
                   lambda a, b: _drop(a, p, training, mode) + b, [x, y])


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     residual_alpha=1.0, begin_norm_axis=1, bias=None,
                     residual=None, quant_scale=-1, quant_round_type=0,
                     quant_max_bound=0, quant_min_bound=0, name=None):
    """LayerNorm over the dims from ``begin_norm_axis`` on of x (+ bias)
    (+ residual_alpha x residual) (:317); with a residual, returns (out,
    the pre-norm sum)."""
    def fn(a, w, b, bi, res):
        if bi is not None:
            a = a + bi
        res_out = None
        if res is not None:
            a = a + residual_alpha * res
            res_out = a
        axes = tuple(range(begin_norm_axis, a.dim()))
        shape = (1,) * begin_norm_axis + tuple(a.shape[begin_norm_axis:])
        out = _ln(a, w.reshape(shape), b.reshape(shape), epsilon, axes)
        return (out, res_out) if res_out is not None else out
    return surface("fused_layer_norm", fn,
                   [x, norm_weight, norm_bias, bias, residual])


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """LayerNorm(dropout(x + bias) + residual) (:346)."""
    def fn(a, res, bi, s, b):
        if bi is not None:
            a = a + bi
        return _ln(_drop(a, dropout_rate, training, mode) + res, s, b,
                   ln_epsilon)
    return surface("fused_bias_dropout_residual_ln", fn,
                   [x, residual, bias, ln_scale, ln_bias])


_FFN_ACTS = {"relu": _relu, "gelu": _gelu}


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True, mode=
                      "upscale_in_train", ring_id=-1, name=None):
    """The Transformer FFN block (:383): [pre-LN] -> linear1 -> act ->
    dropout -> linear2 -> dropout -> + residual [-> post-LN, with the ln2
    parameters, else the ln1 ones]."""
    act = _FFN_ACTS[activation]

    def fn(a, w1, w2, b1, b2, s1, bb1, s2, bb2):
        resid = a
        if pre_layer_norm:
            a = _ln(a, s1, bb1, ln1_epsilon)
        h = a @ w1
        if b1 is not None:
            h = h + b1
        h = _drop(act(h), dropout1_rate, training, mode) @ w2
        if b2 is not None:
            h = h + b2
        out = resid + _drop(h, dropout2_rate, training, mode)
        if not pre_layer_norm:
            out = _ln(out, s2 if s2 is not None else s1,
                      bb2 if bb2 is not None else bb1, ln2_epsilon)
        return out
    return surface("fused_feedforward", fn,
                   [x, linear1_weight, linear2_weight, linear1_bias,
                    linear2_bias, ln1_scale, ln1_bias, ln2_scale, ln2_bias])


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None,
                               ln_bias=None, pre_ln_epsilon=1e-5,
                               qkv_bias=None, linear_bias=None,
                               cache_kv=None, attn_mask=None,
                               dropout_rate=0.5, attn_dropout_rate=0.5,
                               ln_epsilon=1e-5, training=True,
                               mode="upscale_in_train", ring_id=-1,
                               add_residual=True, num_heads=None,
                               name=None):
    """The whole MHA block (:452): [pre-LN] -> QKV -> softmax attention
    (+ an additive ``attn_mask``) -> dropout -> out projection -> dropout
    -> + residual [-> post-LN]. qkv_weight [3, heads, head_dim, embed].
    A ``cache_kv`` is refused, as in the JAX package."""
    if cache_kv is not None:
        raise NotImplementedError(
            "cached decode: use nn.MultiHeadAttention(cache=...); the "
            "fused kernel's cache layout is not carried")

    def fn(a, wqkv, wo, pls, plb, ls, lb, bqkv, bo, mask):
        resid = a
        if pre_layer_norm:
            a = _ln(a, pls, plb, pre_ln_epsilon)
        _, heads, d, _ = wqkv.shape
        qkv = torch.einsum("bse,thde->tbshd", a, wqkv)
        if bqkv is not None:
            qkv = qkv + bqkv.reshape(3, 1, 1, heads, d)
        q, k, v = qkv[0], qkv[1], qkv[2]
        scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(d)
        if mask is not None:
            scores = scores + mask
        attn = _drop(torch.softmax(scores, dim=-1), attn_dropout_rate,
                     training, mode)
        ctx = torch.einsum("bhst,bthd->bshd", attn, v)
        out = ctx.reshape(ctx.shape[0], ctx.shape[1], heads * d) @ wo
        if bo is not None:
            out = out + bo
        out = _drop(out, dropout_rate, training, mode)
        if add_residual:
            out = out + resid
        if not pre_layer_norm:
            out = _ln(out, ls, lb, ln_epsilon)
        return out
    return surface("fused_multi_head_attention", fn,
                   [x, qkv_weight, linear_weight, pre_ln_scale, pre_ln_bias,
                    ln_scale, ln_bias, qkv_bias, linear_bias, attn_mask])


def fused_multi_transformer(*args, **kwargs):
    """(reference: fused_multi_transformer, a whole decoder stack as one
    CUDA call). Refused as in the JAX package (:543): stack
    ``FusedTransformerEncoderLayer``s or ``nn.TransformerEncoder``."""
    raise NotImplementedError(
        "build the transformer stack from FusedTransformerEncoderLayer / "
        "nn.TransformerEncoder layers; this entry's single-call decoder "
        "stack is not carried")
