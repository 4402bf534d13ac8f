"""Paged-KV decode attention (counterpart of
``paddle_tpu/kernels/paged_attention.py``).

The cache is a global pool of fixed-size pages, head-major
``[num_blocks, h_kv, block_size, d]``, addressed per sequence through a
block table ``[b, max_blocks]``. Writes land in page
``block_tables[seq, pos // block_size]``, slot ``pos % block_size``.

- ``paged_attention_arrays``: the plain PyTorch decode step (one gather
  of the sequence's pages + a masked softmax), the contract every kernel
  version is held to.
- ``paged_decode``: the kernel wrapper (counterpart of
  ``paged_decode_pallas``). On a CUDA tensor it launches the hand-written
  Hopper kernels of ``csrc/paged_decode.cu`` (the context split into
  DECODE_CHUNK-token chunks, one block each, then a combine of their
  partials) or raises; the plain version runs only for CPU tensors.
- ``paged_write_arrays`` / ``paged_write_quant_arrays``: append a chunk
  of K/V (int8 + scales for a quantized pool). They update the pools IN
  PLACE (``index_put_``) — where the JAX package donates the pools and
  returns new arrays, the port mutates them and returns the same
  tensors.

GQA: pools carry ``h_kv`` heads; query head ``qh`` reads kv head
``qh // rep``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import monitor
from . import _build

NEG_INF = -1e30

#: per-block shared-memory ceiling of an H100 (227 KB of the SM's 256)
MAX_SMEM_BYTES = 232448
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.int8: 3}
_KV_ITEM = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2,
            torch.int8: 1}
#: what paged_decode_launch reports: (chunk tokens, chunks launched)
_Report = ctypes.c_int * 2
#: csrc/paged_decode.cu: tokens a block (one chunk of the live range),
#: warps a block, the largest head dim (8 values a lane)
DECODE_CHUNK = 64
_WARPS = 4
MAX_HEAD_DIM = 256


def paged_decode_chunks(max_blocks: int, block_size: int) -> int:
    """Chunks the decode kernel launches a (kv head, slot) for a block
    table of ``max_blocks`` pages: the table's capacity over
    DECODE_CHUNK (the C entry reports the number it launched)."""
    return -(-max_blocks * block_size // DECODE_CHUNK)


def paged_decode_smem_bytes(rep: int, d: int, item: int = 4) -> int:
    """Shared memory one block of csrc/paged_decode.cu takes for a
    (rep, head_dim) geometry and a pool of ``item``-byte elements: K and
    V rows of a chunk in the pool dtype (16-byte padded), their int8
    scales, the token row table, the warps' partials for the merge, and
    a 32-byte tail."""
    pitch = -(-d * item // 16) * 16
    groups = _WARPS // min(rep, _WARPS)
    return (2 * DECODE_CHUNK * pitch + 2 * DECODE_CHUNK * 4
            + 8 * DECODE_CHUNK + 4 * groups * rep * (d + 2) + 32)


@functools.lru_cache(maxsize=None)
def paged_kernel_requirements(num_heads, kv_heads, head_dim,
                              cache_dtype) -> Optional[str]:
    """Which limit of the CUDA decode kernel a pool geometry misses, as a
    readable string, or None when the kernel takes it. (Replaces the
    TPU's tile rules in ``paged_pallas_requirements``: any page size
    works; the limits are the pool dtype, the head dim and shared
    memory.)"""
    problems = []
    if cache_dtype not in _KV_DTYPES:
        problems.append(f"cache dtype {cache_dtype} is not one of "
                        f"float32, bfloat16, float16, int8")
    if head_dim > MAX_HEAD_DIM:
        problems.append(f"head_dim {head_dim} is above {MAX_HEAD_DIM} "
                        f"(8 values a lane)")
    if kv_heads < 1 or num_heads % kv_heads:
        problems.append(f"query heads ({num_heads}) are not a multiple of "
                        f"kv heads ({kv_heads})")
    else:
        need = paged_decode_smem_bytes(num_heads // kv_heads, head_dim,
                                       _KV_ITEM.get(cache_dtype, 4))
        if need > MAX_SMEM_BYTES:
            problems.append(
                f"rep {num_heads // kv_heads} x head_dim {head_dim} needs "
                f"{need} bytes of shared memory per block (limit "
                f"{MAX_SMEM_BYTES})")
    return "; ".join(problems) if problems else None


def paged_attention_arrays(q, k_cache, v_cache, block_tables, context_lens,
                           scale: Optional[float] = None,
                           k_scale=None, v_scale=None,
                           window: Optional[int] = None):
    """One decode step of attention against a paged KV cache — the plain
    version (counterpart of ``paged_attention_arrays``, plus the decode
    kernel's sliding ``window``).

    q:            [b, h, d] — this step's query (one token per sequence).
    k_cache/v_cache: [num_blocks, h_kv, block_size, d] page pools.
    block_tables: [b, max_blocks] int — page ids per sequence, in order.
    context_lens: [b] int — tokens visible per sequence (including this
                  step's, already written); 0 marks a dead slot, which
                  emits zeros.
    k_scale/v_scale: [num_blocks, h_kv, block_size] f32 dequant scales
                  of an int8 pool, else None.
    window:       keep only keys within ``window`` of the sequence's own
                  position (``ctx - 1``); None = no window.
    Returns [b, h, d] in q's dtype.
    """
    b, h, d = q.shape
    nb, h_kv, bs, _ = k_cache.shape
    if h_kv < 1 or h % h_kv:
        raise ValueError(
            f"GQA requires query heads ({h}) to be a multiple of cache "
            f"kv heads ({h_kv})")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rep = h // h_kv
    k = gather_pages(k_cache, block_tables)
    v = gather_pages(v_cache, block_tables)
    if k_scale is not None:
        k = k.float() * gather_page_scales(k_scale, block_tables)[..., None]
        v = v.float() * gather_page_scales(v_scale, block_tables)[..., None]
    L = block_tables.shape[1] * bs
    qg = q.reshape(b, h_kv, rep, d).float()
    logits = torch.einsum("bgrd,bLgd->bgrL", qg, k.float()) * scale
    ctx = context_lens.to(torch.int64)[:, None]
    pos = torch.arange(L, device=q.device)[None, :]
    valid = pos < ctx                                          # [b, L]
    if window is not None:
        valid = valid & (pos >= ctx - int(window))
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrL,bLgd->bgrd", p, v.float())
    # dead slots (context 0, or nothing left inside the window) emit
    # zeros, not a uniform average of whatever pages they point at
    live = valid.any(dim=-1)[:, None, None, None]
    out = torch.where(live, out, torch.zeros_like(out))
    return out.reshape(b, h, d).to(q.dtype)


def gather_pages(cache, block_tables):
    """Each sequence's pages as a contiguous [b, L, h_kv, d] copy
    (L = max_blocks * block_size) from the head-major pool."""
    nb, h_kv, bs, d = cache.shape
    b = block_tables.shape[0]
    L = block_tables.shape[1] * bs
    g = cache[block_tables.long()]                 # [b, mb, h_kv, bs, d]
    return g.transpose(2, 3).reshape(b, L, h_kv, d)


def gather_page_scales(scales, block_tables):
    """gather_pages for a per-slot scale pool [num_blocks, h_kv,
    block_size] -> [b, L, h_kv]."""
    nb, h_kv, bs = scales.shape
    b = block_tables.shape[0]
    L = block_tables.shape[1] * bs
    g = scales[block_tables.long()]                # [b, mb, h_kv, bs]
    return g.transpose(2, 3).reshape(b, L, h_kv)


def _page_slots(block_tables, positions, s, bs, check_capacity=True):
    """(page, slot) [b, s] for a chunk of s consecutive tokens starting at
    per-sequence ``positions``.

    A negative position (an idle serving lane, or a row frozen inside a
    multi-tick stretch, at cache index -1) writes into scratch page 0,
    whatever its block-table row holds: a frozen row's table still maps
    its pages, which a prefix cache may share. ``check_capacity`` raises on a
    position past the table's capacity (clamping would overwrite the
    last page); it costs a host sync, so the serving steps, whose
    allocator already guarantees capacity, turn it off."""
    nblk = block_tables.shape[1]
    positions = positions.to(torch.int64)
    if check_capacity:
        pmax = int(positions.max()) + s - 1
        if pmax >= nblk * bs:
            seq = int(positions.argmax())
            raise ValueError(
                f"position {pmax} (sequence {seq}) exceeds the "
                f"block-table capacity {nblk * bs} ({nblk} pages x "
                f"block_size {bs}) — grow the block table / allocate "
                f"more pages first")
    pos = positions[:, None] + torch.arange(s, device=positions.device)[None]
    idx = torch.div(pos, bs, rounding_mode="floor").clamp_(0, nblk - 1)
    page = torch.gather(block_tables.long(), 1, idx)          # [b, s]
    page = torch.where(pos < 0, torch.zeros_like(page), page)
    return page, torch.remainder(pos, bs)


def paged_write_arrays(k, v, k_cache, v_cache, block_tables, positions,
                       check_capacity=True):
    """Append token k/v per sequence into the paged pools, IN PLACE.

    k/v: [b, h_kv, d] (one token per sequence) or [b, s, h_kv, d] (a
    chunk of s consecutive tokens). positions: [b] int — each sequence's
    first position. Returns the (updated, same) (k_cache, v_cache)."""
    bs = k_cache.shape[2]
    if k.dim() == 3:
        k, v = k[:, None], v[:, None]
    page, slot = _page_slots(block_tables, positions, k.shape[1], bs,
                             check_capacity)
    # advanced indices around the ':' head slice index [b, s, h_kv, d]
    k_cache[page, :, slot] = k.to(k_cache.dtype)
    v_cache[page, :, slot] = v.to(v_cache.dtype)
    return k_cache, v_cache


def paged_write_quant_arrays(k, v, k_cache, v_cache, k_scale, v_scale,
                             block_tables, positions, check_capacity=True):
    """paged_write_arrays for an int8 pool: quantizes per (token,
    kv_head) and writes values AND scales, in place. Returns the four
    (updated, same) pools."""
    from ..quantization.functional import kv_quantize_arrays

    bs = k_cache.shape[2]
    if k.dim() == 3:
        k, v = k[:, None], v[:, None]
    qk, sk = kv_quantize_arrays(k)
    qv, sv = kv_quantize_arrays(v)
    page, slot = _page_slots(block_tables, positions, k.shape[1], bs,
                             check_capacity)
    k_cache[page, :, slot] = qk
    v_cache[page, :, slot] = qv
    k_scale[page, :, slot] = sk
    v_scale[page, :, slot] = sv
    return k_cache, v_cache, k_scale, v_scale


def paged_decode(q, k_cache, v_cache, block_tables, context_lens,
                 scale: Optional[float] = None,
                 window: Optional[int] = None,
                 k_scale=None, v_scale=None):
    """Multi-sequence single-token paged decode: q [b, h, d] against the
    page pools through the block tables, masked to ``context_lens`` (and
    a sliding ``window``). Returns [b, h, d] in q's dtype.

    On CUDA tensors this launches ``csrc/paged_decode.cu`` (blocks over
    (chunk of the context, kv head, slot), then a combine of the chunks'
    partials; dead slots load nothing and emit zeros) and counts the call
    on ``paged_decode.launches`` and, by what the C entry reports it ran,
    on ``kernels.decode.paged_cuda_split`` (more than one chunk a slot,
    and the combine) or ``kernels.decode.paged_cuda_single``; on CPU
    tensors it runs the plain ``paged_attention_arrays``."""
    b, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        monitor.counter("kernels.decode.paged_plain").increase()
        return paged_attention_arrays(q, k_cache, v_cache, block_tables,
                                      context_lens, scale=scale,
                                      k_scale=k_scale, v_scale=v_scale,
                                      window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    return _paged_decode_cuda(q, k_cache, v_cache, block_tables,
                              context_lens, scale, window, k_scale, v_scale)


paged_decode.launches = 0


def _check_cuda(q, k_cache, v_cache, block_tables, context_lens, k_scale,
                v_scale):
    b, h, d = q.shape
    nb, h_kv, bs, dk = k_cache.shape
    quant = k_cache.dtype == torch.int8
    why = paged_kernel_requirements(h, h_kv, d, k_cache.dtype)
    if why:
        raise ValueError(f"paged_decode kernel cannot take this pool: {why}")
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype \
            or dk != d:
        raise ValueError(
            f"paged_decode: k/v pools {tuple(k_cache.shape)} "
            f"{k_cache.dtype} / {tuple(v_cache.shape)} {v_cache.dtype} "
            f"do not match each other or head_dim {d}")
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode: an int8 pool needs k_scale and "
                         "v_scale, and only an int8 pool takes them")
    tensors = [q, k_cache, v_cache, block_tables, context_lens]
    if quant:
        tensors += [k_scale, v_scale]
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (nb, h_kv, bs) \
                    or not s.is_contiguous():
                raise ValueError(
                    "paged_decode: scale pools must be contiguous f32 "
                    f"[{nb}, {h_kv}, {bs}]")
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode: all tensors must be on one device")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("paged_decode: page pools must be contiguous")
    if block_tables.shape[0] != b or context_lens.shape != (b,):
        raise ValueError(
            f"paged_decode: block_tables {tuple(block_tables.shape)} / "
            f"context_lens {tuple(context_lens.shape)} do not match "
            f"batch {b}")
    # (a call each only where a cast or a copy is needed: these run in
    # every layer of every decode tick)
    return (_as(q, torch.float32), _as(block_tables, torch.int32),
            _as(context_lens, torch.int32))


def _as(t, dtype):
    return (t if t.dtype == dtype and t.is_contiguous()
            else t.to(dtype).contiguous())


def decode_scratch(q, block_tables, block_size):
    """The split kernel's f32 scratch for one call, one allocation: the
    chunks' unnormalised accumulators [b, h, nch, d], then their (m, l)
    [b, h, nch, 2] (``decode_partials`` views them); empty when the
    table holds one chunk (no combine)."""
    b, h, d = q.shape
    nch = paged_decode_chunks(block_tables.shape[1], block_size)
    return torch.empty(0 if nch == 1 else b * h * nch * (d + 2),
                       dtype=torch.float32, device=q.device)


def decode_partials(scratch, b, h, d):
    """(acc [b, h, nch, d], (m, l) [b, h, nch, 2]) views of a
    ``decode_scratch`` tensor."""
    nch = scratch.numel() // (b * h * (d + 2))
    n = b * h * nch * d
    return (scratch[:n].view(b, h, nch, d),
            scratch[n:].view(b, h, nch, 2))


def _decode_launch(qf, k_cache, v_cache, bt, cl, out, scratch, scale,
                   window, k_scale=None, v_scale=None):
    """One launch of ``paged_decode_launch`` on checked operands (f32
    contiguous ``qf``, int32 ``bt`` and ``cl``) into ``out`` [b, h, d]
    f32 with the ``scratch`` of ``decode_scratch``, uncounted; raises on
    a refused launch. Returns what the C entry reports it ran: (chunk
    tokens, chunks a (kv head, slot))."""
    b, h, d = qf.shape
    _, h_kv, bs, _ = k_cache.shape
    quant = k_cache.dtype == torch.int8
    nch = scratch.numel() // (b * h * (d + 2))
    part = scratch.data_ptr() if nch else None
    lib = _build.load("paged_decode")
    report = _Report(-1, -1)
    _build.check(lib.paged_decode_launch(
        qf.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        bt.data_ptr(), cl.data_ptr(), out.data_ptr(), part,
        part and part + 4 * b * h * nch * d, nch,
        b, h, h_kv, d, bs, bt.shape[1],
        0 if window is None else int(window), float(scale),
        _KV_DTYPES[k_cache.dtype],
        _build.stream(qf.device),
        ctypes.addressof(report)), "paged_decode kernel")
    return report[0], report[1]


def _paged_decode_cuda(q, k_cache, v_cache, block_tables, context_lens,
                       scale, window, k_scale, v_scale):
    b, h, d = q.shape
    qf, bt, cl = _check_cuda(q, k_cache, v_cache, block_tables,
                             context_lens, k_scale, v_scale)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out.to(q.dtype)
    _, nch = _decode_launch(qf, k_cache, v_cache, bt, cl, out,
                            decode_scratch(qf, bt, k_cache.shape[2]),
                            scale, window, k_scale, v_scale)
    paged_decode.launches += 1
    monitor.counter("kernels.decode.paged_cuda").increase()
    monitor.counter("kernels.decode.paged_cuda_"
                    + ("split" if nch > 1 else "single")).increase()
    return out if q.dtype == torch.float32 else out.to(q.dtype)
