"""Flash attention forward (counterpart of
``paddle_tpu/kernels/flash_attention.py``, forward only).

- ``flash_plain``: the plain PyTorch attention on [B, H, S, D]
  (counterpart of ``_flash_xla``, :747) — the contract the kernel is
  held to.
- ``flash_fwd``: the kernel wrapper (counterpart of ``_flash_pallas_fwd``,
  :387) on the paddle layout [B, S, H, D]. On CUDA tensors it launches
  the hand-written Hopper kernel ``csrc/flash_fwd.cu`` or raises; the
  plain version runs only for CPU tensors.
- ``flash_attention_arrays`` / ``flash_attention``: the validated entry
  (counterparts of :871 and :943).

Semantics shared by both versions: causal masking is bottom-right
aligned (query i sees keys j <= i + sk - sq); GQA by index (query head h
reads kv head h // rep); an optional sliding window keeps keys with
i + sk - sq - j < window; a row that sees no key outputs 0. Flashmask
(``startend_row_indices``) and the logsumexp output come with the
backward kernels in the training slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import monitor
from . import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256


def flash_plain(q, k, v, causal, scale, window=None):
    """Plain attention on q [B, H, Sq, D], k/v [B, H_kv, Sk, D] (the
    counterpart of ``_flash_xla``): logits in the input dtype, softmax
    in f32, probabilities cast back, fully masked rows zeroed."""
    h = q.shape[1]
    if k.shape[1] != h:
        rep = h // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    sq, sk = logits.shape[-2], logits.shape[-1]
    if not causal:
        p = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bhkd->bhqd", p, v)
    qi = torch.arange(sq, device=q.device)[:, None]
    kj = torch.arange(sk, device=q.device)[None, :]
    mask = qi + (sk - sq) >= kj
    if window is not None:
        mask = mask & (qi + (sk - sq) - kj < int(window))
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    # rows with no visible key (sq > sk, or a window past the start)
    # emit zeros, not softmax's uniform average of V
    return torch.where(mask.any(-1)[:, None], out, torch.zeros_like(out))


def flash_fwd(q, k, v, causal: bool, scale: float,
              window: Optional[int] = None):
    """Flash forward on the paddle layout: q [B, Sq, H, D], k/v
    [B, Sk, H_kv, D] -> [B, Sq, H, D].

    On CUDA tensors this launches ``csrc/flash_fwd.cu`` (any sequence
    lengths, head dim <= 256, unit last-dim stride) and counts the launch
    on ``flash_fwd.launches``; on CPU tensors it runs ``flash_plain``."""
    if q.device.type == "cpu":
        monitor.counter("kernels.flash.fwd_plain").increase()
        out = flash_plain(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal, scale, window)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    return _flash_fwd_cuda(q, k, v, causal, scale, window)


flash_fwd.launches = 0


def _flash_fwd_cuda(q, k, v, causal, scale, window):
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_fwd kernel takes float32/bfloat16/float16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {D}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_fwd: q, k and v must be on one device")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_fwd")
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Hkv, Sq, Sk, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), 0 if window is None else int(window),
        float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd kernel")
    flash_fwd.launches += 1
    monitor.counter("kernels.flash.fwd_cuda").increase()
    return out


def flash_attention_arrays(q, k, v, causal=False, scale=None,
                           window=None, startend_row_indices=None):
    """Attention entry on the paddle layout [B, S, H, D] (counterpart of
    ``flash_attention_arrays``). k/v may carry fewer heads than q (GQA,
    served in-kernel). ``window`` requires ``causal=True``."""
    if startend_row_indices is not None:
        raise NotImplementedError(
            "flashmask (startend_row_indices) comes with the flash "
            "backward kernels in the training slice of the port")
    if k.shape[2] != v.shape[2]:
        raise ValueError(
            f"key heads ({k.shape[2]}) != value heads ({v.shape[2]})")
    if k.shape[2] < 1 or q.shape[2] % k.shape[2] != 0:
        raise ValueError(
            f"GQA requires query heads ({q.shape[2]}) to be a multiple "
            f"of key/value heads ({k.shape[2]})")
    if window is not None:
        window = int(window)
        if not causal:
            raise ValueError(
                "flash attention window requires causal=True (the "
                "window is measured back from the causal diagonal)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return flash_fwd(q, k, v, causal, s, window)


#: the models' entry (the JAX package's tensor-level name)
flash_attention = flash_attention_arrays
