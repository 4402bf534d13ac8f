"""Attention functionals (counterpart of ``paddle_tpu/nn/functional/attention.py``).

``scaled_dot_product_attention`` is the kernel entry of the eager
surface: on the paddle layout [batch, seq, heads, head_dim] it routes as
the JAX package routes (:116-137) — no mask, or a bool key (padding)
mask, to the flash kernels (``kernels.flash_attention``; the CUDA
kernels on a CUDA tensor, their plain versions on a CPU one), any other
mask to the plain core. Surface Tensors go through ``run_op`` (the op
is on neither AMP list, so it runs in the dtype q, k and v arrive in);
raw torch tensors take the same body and come out raw.
"""
from __future__ import annotations

import torch

from ... import monitor
from ...core.dispatch import surface, unwrap, wrap
from ...core.flags import define_flag, get_flag
from ...core.tensor import Tensor

define_flag("sdpa_use_flash", True,
            "route scaled_dot_product_attention through the flash entry "
            "when the request is expressible (no mask / bool key-padding "
            "masks); 0 pins every sdpa on surface Tensors to the plain "
            "softmax core")


def document_startend_row_indices(doc_lens, total=None, device=None):
    """Causal document mask as flashmask ``startend_row_indices``
    ([1, 1, total, 1] int32; counterpart of :293): token i may attend
    token j iff j <= i and both sit in the same packed document. Each key
    column's band masks rows from its document's end on."""
    lens = [int(n) for n in doc_lens]
    if any(n < 1 for n in lens):
        raise ValueError(f"document lengths must be >= 1, got {lens}")
    s = sum(lens)
    total = s if total is None else int(total)
    if s != total:
        raise ValueError(
            f"doc_lens sum to {s} but total={total} — packed documents "
            f"must tile the whole sequence")
    ends = torch.repeat_interleave(
        torch.cumsum(torch.tensor(lens), 0), torch.tensor(lens))
    return ends.to(torch.int32).reshape(1, 1, total, 1).to(device)


def _sdpa_core(q, k, v, mask=None, causal=False):
    """Plain attention on the paddle layout [B, S, H, D] (counterpart of
    ``attention.py:25``): logits in the input dtype, a bool mask keeps
    where True (-inf elsewhere) and any other mask is added, softmax in
    f32 cast back. A row whose every key is masked gives NaN, as in the
    JAX package's core."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _mask_to_key_bands(mask, batch, sq, sk, n_heads):
    """A bool keep-mask with no query structure -> flashmask
    ``startend_row_indices`` [b, h_se, sk, 1] int32, or None when it is
    not a pure key (padding) mask (counterpart of ``attention.py:48``).
    Accepted: [b, 1, sk] and [b, h|1, 1, sk]. A kept column becomes the
    empty band [sq, sq), a masked one [0, sq)."""
    if mask is None or mask.dtype != torch.bool:
        return None
    m = mask
    if m.dim() == 3:
        if tuple(m.shape) != (batch, 1, sk):
            return None
        m = m[:, :, None, :]
    elif m.dim() == 4:
        if m.shape[0] != batch or m.shape[2] != 1 or m.shape[3] != sk:
            return None
    else:
        return None
    h_se = m.shape[1]
    if h_se != 1 and (h_se > n_heads or n_heads % h_se):
        return None
    se = torch.where(m[:, :, 0, :], sq, 0).to(torch.int32)
    return se[..., None]


def _sdpa(query, key, value, attn_mask, is_causal, use_flash):
    from ...kernels.flash_attention import flash_attention_arrays
    if not use_flash:
        monitor.counter("kernels.flash.sdpa.core").increase()
        return _sdpa_core(query, key, value, attn_mask, is_causal)
    b, sq, sk = query.shape[0], query.shape[1], key.shape[1]
    se = None
    if attn_mask is not None:
        if sq == sk:
            se = _mask_to_key_bands(attn_mask, b, sq, sk, key.shape[2])
        if se is None:
            monitor.counter("kernels.flash.sdpa.dense_mask").increase()
            return _sdpa_core(query, key, value, attn_mask, is_causal)
    route = "plain" if query.device.type == "cpu" else "kernel"
    suffix = "_mask" if se is not None else ""
    monitor.counter(f"kernels.flash.sdpa.{route}{suffix}").increase()
    return flash_attention_arrays(query, key, value, causal=is_causal,
                                  startend_row_indices=se)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *,
                                 use_flash=True):
    """Attention on the paddle layout [batch, seq, heads, head_dim]
    (counterpart of ``attention.py:81``), routed as the JAX package
    routes it (:116-137):

    - no mask, or a bool key (padding) mask of shape [b, 1, sk] or
      [b, h|1, 1, sk] with sq == sk, which becomes flashmask C=1 column
      bands: ``kernels.flash_attention.flash_attention_arrays`` — the
      CUDA flash kernels on a CUDA tensor, their plain versions on a CPU
      tensor (counters ``kernels.flash.sdpa.kernel[_mask]`` /
      ``.plain[_mask]``). A row whose every key is masked gives zeros.
    - any other mask: the plain ``_sdpa_core`` (``.dense_mask``), which
      the JAX package computes with XLA, not Pallas;
    - ``use_flash=False``: the plain core (``.core``); on surface
      Tensors ``FLAGS_sdpa_use_flash=0`` too (the escape hatch for
      callers that keep the reference signature, such as
      ``nn.MultiHeadAttention``). Raw torch tensors (the port's models)
      read no flag: only ``use_flash=`` moves them off the kernels.

    ``dropout_p`` is accepted and not applied, as in the JAX package
    (:101-103)."""
    args = [query, key, value, attn_mask]
    if any(isinstance(a, Tensor) for a in args):
        use_flash = use_flash and get_flag("sdpa_use_flash")
    return surface("scaled_dot_product_attention", _sdpa, args,
                   is_causal=is_causal, use_flash=use_flash)


def _probs(q, k, causal):
    """The [B, H, Sq, Sk] f32 softmax of flash_attention's
    ``return_softmax`` (recomputed densely; GQA repeats the kv heads)."""
    qt = q.transpose(1, 2).float()
    kt = k.transpose(1, 2).float()
    if kt.shape[1] != qt.shape[1]:
        kt = kt.repeat_interleave(qt.shape[1] // kt.shape[1], dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt) / qt.shape[-1] ** 0.5
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    return torch.softmax(logits, dim=-1)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None, *, window=None):
    """paddle's flash_attention: (out, softmax or None). k / v may carry
    fewer heads than q (GQA); ``window`` is a causal sliding window (not
    with ``return_softmax``). ``dropout`` is not applied, as in the JAX
    package."""
    from ...kernels.flash_attention import flash_attention_arrays
    if window is not None and return_softmax:
        raise ValueError("return_softmax with window is not supported")
    out = surface("flash_attention", lambda q, k, v: flash_attention_arrays(
        q, k, v, causal=causal, window=window), [query, key, value])
    if return_softmax:
        return out, surface("flash_attention_softmax", _probs, [query, key],
                            causal=causal)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False, name=None):
    """Varlen attention over packed sequences (q/k/v [total, heads,
    dim], ``cu_seqlens`` the sequence boundaries) as one dense attention
    over the packed axis with a block-diagonal segment mask. Returns
    (out, None)."""
    def fn(q, k, v, cq, ck):
        tq, tk = q.shape[0], k.shape[0]
        pos_q = torch.arange(tq, device=q.device)
        pos_k = torch.arange(tk, device=q.device)
        seg_q = torch.sum(pos_q[:, None] >= cq[None, 1:], dim=-1)
        seg_k = torch.sum(pos_k[:, None] >= ck[None, 1:], dim=-1)
        mask = seg_q[:, None] == seg_k[None, :]
        if causal:
            mask = mask & ((pos_q - cq[seg_q])[:, None]
                           >= (pos_k - ck[seg_k])[None, :])
        scores = torch.einsum("qhd,khd->hqk", q, k) * scale
        scores = torch.where(mask[None], scores,
                             torch.full_like(scores, -1e30))
        return torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)
    return surface("flash_attn_unpadded", fn, [query, key, value,
                                               cu_seqlens_q, cu_seqlens_k]), \
        None


def _split3(qkv, axis):
    a = unwrap(qkv)
    parts = [a.select(axis, i) for i in range(3)]
    return [wrap(p) for p in parts] if a is not qkv else parts


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale=None,
                                dropout=0.0, causal=False,
                                return_softmax=False, name=None):
    """Packed-QKV varlen attention; qkv [total, 3, heads, dim]."""
    q, k, v = _split3(qkv, 1)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    return flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                               max_seqlen_q, max_seqlen_k, scale, dropout,
                               causal)


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    from ...core import dtype as dtype_mod
    want = dtype_mod.to_torch(dtype)

    def fn(ln):
        m = maxlen if maxlen is not None else int(ln.max())
        return (torch.arange(m, device=ln.device)[None, :]
                < ln[:, None]).to(want)
    return surface("sequence_mask", fn, [lengths])


def flash_attn(q, k, v, dropout=0.0, causal=False, return_softmax=False,
               **kw):
    return flash_attention(q, k, v, dropout=dropout, causal=causal)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, **kw):
    """qkv [b, s, 3, h, d]."""
    q, k, v = _split3(qkv, 2)
    return flash_attention(q, k, v, dropout=dropout, causal=causal)


def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale=None, training=True, **kw):
    return scaled_dot_product_attention(query, key, value,
                                        attn_mask=attn_bias, dropout_p=p,
                                        training=training)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        name=None):
    """FlashMask: a sparse mask as per-key-column row bands
    [b, h_se, s_k, {1,2,4}] int32, served by the flash kernels;
    ``window_size`` composes a causal sliding window."""
    from ...kernels.flash_attention import flash_attention_arrays
    if startend_row_indices is None:
        return flash_attention(query, key, value, dropout=dropout,
                               causal=causal, window=window_size)[0]
    if window_size is not None and not causal:
        raise ValueError("flashmask window_size requires causal=True")
    window = None if window_size is None else int(window_size)
    return surface("flashmask_attention",
                   lambda q, k, v, se: flash_attention_arrays(
                       q, k, v, causal=causal, window=window,
                       startend_row_indices=se),
                   [query, key, value, startend_row_indices])
