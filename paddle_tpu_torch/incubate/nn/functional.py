"""Fused-op subset of the LLaMA path (counterparts of
``paddle_tpu/incubate/nn/functional/__init__.py:92``
``fused_rotary_position_embedding`` and :173
``fused_linear_cross_entropy``)."""
from __future__ import annotations

import torch


def _rope_tables(d, position_ids, s_len, dtype, device):
    """Neox-layout sin/cos tables [b|1, s, 1, d] in ``dtype``: angles in
    f32 at base 10000, ``position_ids`` [s] or [b, s] (None = arange)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=device) / d))
    if position_ids is None:
        pos_idx = torch.arange(s_len, device=device)
    else:
        pos_idx = torch.as_tensor(position_ids, device=device)
    pos = pos_idx.to(torch.float32)[..., :, None] * inv      # [..., s, d/2]
    s_a = torch.cat([torch.sin(pos), torch.sin(pos)], dim=-1)
    c_a = torch.cat([torch.cos(pos), torch.cos(pos)], dim=-1)
    s_a = s_a.to(dtype)[..., :, None, :]
    c_a = c_a.to(dtype)[..., :, None, :]
    if s_a.dim() == 3:                       # shared positions: batch dim
        s_a, c_a = s_a[None], c_a[None]
    return s_a, c_a


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """RoPE on [b, s, h, d] tensors, neox style (rotate halves). Returns
    the rotated (q, k, v) with None for absent inputs; v passes through
    rotated like the JAX package does when given."""
    if not use_neox_rotary_style:
        raise NotImplementedError(
            "interleaved (non-neox) RoPE is not carried by the port's "
            "serving slice")
    if sin is not None or cos is not None:
        raise NotImplementedError(
            "user sin/cos tables are not carried by the port's serving "
            "slice")

    def make(t):
        if t is None:
            return None
        d = t.shape[-1]
        s_a, c_a = _rope_tables(d, position_ids, t.shape[1], t.dtype,
                                t.device)
        t1, t2 = t[..., : d // 2], t[..., d // 2:]
        rot = torch.cat([-t2, t1], dim=-1)
        return t * c_a + rot * s_a

    return tuple(make(t) for t in (q, k, v))


def _chunk_stats(hc, w, lc, ignore_index):
    """f32 logits of one row chunk and their logsumexp, the clipped
    label index and the validity mask (:216-221)."""
    logits = (hc @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    v = logits.shape[-1]
    safe = torch.clamp(lc, 0, v - 1)
    # labels outside [0, V) are invalid, not clipped to a class
    valid = (lc != ignore_index) & (lc >= 0) & (lc < v)
    return logits, lse, safe, valid


class _FusedLinearCE(torch.autograd.Function):
    """Mean NLL of ``softmax(h @ w)`` over row chunks. The forward keeps
    no logits; the backward recomputes each chunk's logits, so one
    [rows / chunks, V] f32 tile is alive at a time (the JAX package's
    ``jax.checkpoint`` over the scan body, :226)."""

    @staticmethod
    def forward(ctx, hs, w, ls, ignore_index, chunks):
        tot = torch.zeros((), dtype=torch.float32, device=hs.device)
        cnt = torch.zeros((), dtype=torch.float32, device=hs.device)
        for hc, lc in zip(hs.chunk(chunks), ls.chunk(chunks)):
            logits, lse, safe, valid = _chunk_stats(hc, w, lc, ignore_index)
            picked = logits.gather(-1, safe[:, None])[:, 0]
            tot = tot + torch.where(valid, lse - picked, 0.0).sum()
            cnt = cnt + valid.float().sum()
            del logits
        denom = torch.clamp(cnt, min=1.0)
        ctx.save_for_backward(hs, w, ls, denom)
        ctx.ignore_index, ctx.chunks = ignore_index, chunks
        return tot / denom

    @staticmethod
    def backward(ctx, g):
        hs, w, ls, denom = ctx.saved_tensors
        coef = (g.float() / denom)
        dh = torch.empty_like(hs)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        rows = 0
        for hc, lc in zip(hs.chunk(ctx.chunks), ls.chunk(ctx.chunks)):
            logits, lse, safe, valid = _chunk_stats(hc, w, lc,
                                                    ctx.ignore_index)
            # d(lse - picked)/dlogits = softmax - onehot, on valid rows
            dlog = torch.exp(logits.sub_(lse[:, None]))
            dlog.scatter_add_(-1, safe[:, None],
                              torch.full_like(lse[:, None], -1.0))
            dlog.mul_((valid.float() * coef)[:, None])
            # the f32 logits' cotangent reaches the matmul in its dtype,
            # as the autodiff of astype does
            dlog = dlog.to(w.dtype)
            dh[rows:rows + hc.shape[0]] = dlog @ w.t()
            dw += (hc.t() @ dlog).float()
            rows += hc.shape[0]
            del logits, dlog
        return dh, dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100,
                               n_chunks=8):
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
    Gradients flow to hidden and weight."""
    if int(n_chunks) < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    hs = hidden.reshape(-1, hidden.shape[-1])
    ls = torch.as_tensor(labels, device=hidden.device).reshape(-1).long()
    n = hs.shape[0]
    chunks = int(min(n_chunks, n))
    if n % chunks:
        # pad with ignored rows so the chunking survives ragged batches
        pad = chunks - n % chunks
        hs = torch.cat([hs, hs.new_zeros(pad, hs.shape[-1])])
        ls = torch.cat([ls, ls.new_full((pad,), ignore_index)])
    return _FusedLinearCE.apply(hs, weight, ls, int(ignore_index), chunks)
