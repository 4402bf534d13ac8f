"""nn.functional subset of the LLaMA and BERT paths (counterparts of
``paddle_tpu/nn/functional/norm.py`` ``rms_norm`` and ``layer_norm``,
``activation.py`` ``silu`` and ``gelu``, ``common.py`` ``dropout``, the
losses, and ``attention.py`` ``scaled_dot_product_attention``).

Under bf16 AMP the JAX package rounds every intermediate to bf16 at
points the functions below copy one by one, so that a bf16 result is the
JAX one bit for bit; in f32 the two differ only by the order of sums and
the ``erfc`` polynomial (ulps)."""
from __future__ import annotations

import math

import torch

from .. import monitor


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` dims (counterpart
    of ``norm.py:26``) in the JAX package's order of roundings: the mean
    in f32 rounded to x's dtype, the variance of the f32-centred values
    in f32 rounded to x's dtype, then ``(x - mean) / sqrt(var + eps)``,
    ``* weight`` and ``+ bias`` in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    out = (x - mean.to(x.dtype)) / torch.sqrt(var.to(x.dtype) + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def gelu(x, approximate=False):
    """GELU as ``jax.nn.gelu`` computes it in x's dtype (``activation.py
    :37``): exact, ``0.5 * x * erfc(-x * sqrt(0.5))`` with ``sqrt(0.5)``
    in x's dtype and ``erfc`` taken in f32 and rounded; ``approximate``,
    the tanh form ``x * 0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715
    x^3)))``."""
    if approximate:
        c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype)
    return (0.5 * x) * torch.erfc((-x * sqrt_half).float()).to(x.dtype)


def dropout(x, p=0.5, training=True, mode="upscale_in_train",
            generator=None):
    """Dropout (counterpart of ``common.py:25``). ``upscale_in_train``
    keeps each element with probability 1 - p and scales it by 1/(1 - p)
    in training, identity in eval; ``downscale_in_infer`` keeps without
    scaling in training and scales by 1 - p in eval. p 0 is identity and
    p 1 zeros in training. The mask is drawn as f32 uniforms from
    ``generator`` (a ``torch.Generator`` on x's device; the default one
    when None): the JAX package's threefry keys cannot be reproduced, so
    only the distribution matches."""
    if isinstance(p, (int, float)) and not 0 <= p <= 1:
        raise ValueError(f"dropout p must be in [0, 1], got {p}")
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be upscale_in_train or "
                         f"downscale_in_infer, got {mode!r}")
    if not training:
        return x * (1.0 - p) if mode == "downscale_in_infer" else x
    if p == 0:
        return x
    if p == 1:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm: the mean square is taken in f32, and x is multiplied by
    ``rsqrt(ms + eps)`` cast to x's dtype (then by ``weight``) — the same
    order of roundings as the JAX package."""
    ms = x.float().square().mean(dim=-1, keepdim=True)
    out = x * torch.reciprocal(torch.sqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def silu(x):
    return torch.nn.functional.silu(x)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross entropy with hard (integer) labels (counterpart of
    ``paddle_tpu/nn/functional/loss.py:28``): ``log_softmax`` in the
    logits' dtype (bf16 under AMP, as the JAX package does), labels equal
    to ``ignore_index`` contribute nothing, and ``"mean"`` divides by the
    number of valid labels (at least 1). ``label`` may carry a trailing
    size-1 class axis."""
    if soft_label or weight is not None or label_smoothing or \
            not use_softmax:
        raise NotImplementedError(
            "soft labels, class weights, label smoothing and "
            "use_softmax=False come with a later slice of the port")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean/sum/none, got {reduction}")
    lp = torch.log_softmax(input, dim=axis)
    lab = torch.as_tensor(label, device=input.device)
    if lab.dim() == input.dim():
        lab = lab.squeeze(axis)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = torch.gather(lp, axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, 0.0)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum().to(loss.dtype), min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss


def document_startend_row_indices(doc_lens, total=None, device=None):
    """Causal document mask as flashmask ``startend_row_indices``
    ([1, 1, total, 1] int32; counterpart of
    ``paddle_tpu/nn/functional/attention.py:293``): token i may attend
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


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, *, use_flash=True):
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
    - ``use_flash=False``: the plain core (``.core``).

    ``dropout_p`` is accepted and not applied, as in the JAX package
    (:101-103)."""
    from ..kernels.flash_attention import flash_attention_arrays
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
