"""Ring attention: context parallelism over the ``sep`` group (counterpart
of ``paddle_tpu/kernels/ring_attention.py``).

Each rank of the sep group holds a chunk of the sequence: q, k and v
[b, h, s / n, d], rank r the positions [r s / n, (r + 1) s / n). Each
rank attends its queries to every rank's k / v block with the online
softmax, the blocks rotating one ring hop at a time (rank r sends to
r + 1 and receives from r - 1), so no rank holds the whole sequence
(Liu et al., Ring Attention with Blockwise Transformers).

The hop's body is the JAX package's ``_ring_local`` (:30-96), which is
``jnp.einsum`` there, not Pallas: plain PyTorch in f32 here, as the port
keeps ordinary ops ordinary. q is scaled in f32; GQA's query heads fold
into the row dim (a kv group's ``rep`` heads one after the other), so
only the grouped k / v rotate; the global positions are the block's
source rank times s / n; causal and window bands apply; the online
softmax guards fully masked rows (``NEG_INF``); ``out = acc / max(l,
1e-30)``, cast back to the input dtype.

The JAX package differentiates through ``lax.scan`` and ``ppermute``
(whose transposes counter-rotate the cotangents). The port's backward
(``_RingAttention``) replays the ring: the forward keeps q, this rank's
k / v, the block it held last, the f32 output and the row logsumexp; the
backward walks the hops in reverse, each block travelling back toward its
owner (rank r sends to r - 1) together with its dK / dV accumulators, so
that at the last hop every rank holds its own block's gradients. p is
recomputed from the logsumexp, as a flash backward does.

Hops are one ``batch_isend_irecv`` each (k and v stacked, dK and dV
stacked), counted by the collectives' ``send`` / ``recv`` counters (under
gloo, bytes staged through host memory). With ``sep`` <= 1 the entries
go to the port's flash entry (``kernels.flash_attention``: the CUDA
kernels on the card), as the JAX one does (:120-129).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _band(pos_q, k_off, s_local, causal, window, device):
    """The [rows, s_local] keep-mask of a hop (None without causal)."""
    if not causal:
        return None
    pos_k = k_off + torch.arange(s_local, device=device)
    mask = pos_q[:, None] >= pos_k[None, :]
    if window is not None:
        mask &= (pos_q[:, None] - pos_k[None, :]) < window
    return mask


def fwd_hop(q32, kk, vv, acc, m, l, pos_q, k_off, causal, window):
    """One online-softmax hop of the f32, pre-scaled, GQA-folded queries
    ``q32`` [b, h_kv, rows, d] against a k / v block at global offset
    ``k_off``: the updated (acc, m, l)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q32, kk.float())
    mask = _band(pos_q, k_off, kk.shape[2], causal, window, q32.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows (exp(NEG_INF - NEG_INF) would be 1)
    p = torch.exp(s - m_new[..., None])
    p = torch.where(s > NEG_INF * 0.5, p, torch.zeros_like(p))
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                               vv.float())
    return acc, m_new, l


def fwd_finish(acc, m, l):
    """The normalized f32 output and the rows' logsumexp (0 on a row that
    saw no key)."""
    lc = torch.clamp(l, min=1e-30)
    out = acc / lc[..., None]
    lse = torch.where(l > 0, m + torch.log(lc), torch.zeros_like(m))
    return out, lse


def bwd_hop(q32, do32, lse, d_rows, kk, vv, dk, dv, dq, pos_q, k_off,
            causal, window):
    """One backward hop against a k / v block: p replayed from the
    logsumexp; dq (of the scaled queries) accumulated here, dK / dV on
    the block's own accumulators."""
    kk, vv = kk.float(), vv.float()
    s = torch.einsum("bhqd,bhkd->bhqk", q32, kk)
    mask = _band(pos_q, k_off, kk.shape[2], causal, window, q32.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])
    p = torch.where(s > NEG_INF * 0.5, p, torch.zeros_like(p))
    dv = dv + torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, vv)
    ds = p * (dp - d_rows[..., None])
    dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kk)
    dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, q32)
    return dq, dk, dv


def fold_queries(q, scale, block, h_kv):
    """(q32, pos_q): the f32 scaled queries of the chunk at ``block`` with
    a GQA group's heads folded into the rows ([b, h_kv, rep * s, d]), and
    each row's global position (row r * s + j at position j's)."""
    b, h, sl, d = q.shape
    q32 = q.float() * scale
    pos_q = block * sl + torch.arange(sl, device=q.device)
    rep = h // h_kv
    if rep > 1:
        q32 = q32.reshape(b, h_kv, rep * sl, d)
        pos_q = pos_q.repeat(rep)
    return q32, pos_q


def _exchange(t, group, to, frm):
    """Send ``t`` to group rank ``to``, receive its like from ``frm``."""
    from ..distributed.communication import collectives as C
    got = torch.empty_like(t)
    tasks = C.batch_isend_irecv([
        C.P2POp(C.isend, t.contiguous(), group.ranks[to], group),
        C.P2POp(C.irecv, got, group.ranks[frm], group)])
    for task in tasks:
        task.wait()
    return got


class _RingAttention(torch.autograd.Function):
    """Exact attention of this rank's chunk against every rank's, the
    k / v blocks rotating over ``group``; the backward replays the ring
    in reverse (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, window):
        n, r = group.nranks, group.rank
        b, h, sl, d = q.shape
        h_kv = k.shape[1]
        q32, pos_q = fold_queries(q, scale, r, h_kv)
        acc = torch.zeros(q32.shape[:3] + (v.shape[3],), dtype=torch.float32,
                          device=q.device)
        m = torch.full(q32.shape[:3], NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(q32.shape[:3], dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        for step in range(n):
            src = (r - step) % n
            acc, m, l = fwd_hop(q32, kv[0], kv[1], acc, m, l, pos_q,
                                src * sl, causal, window)
            if step < n - 1:
                kv = _exchange(kv, group, (r + 1) % n, (r - 1) % n)
        out32, lse = fwd_finish(acc, m, l)
        ctx.save_for_backward(q32, pos_q, kv, out32, lse)
        ctx.group, ctx.causal, ctx.scale, ctx.window = group, causal, \
            scale, window
        ctx.shapes = (q.shape, q.dtype, k.dtype, v.dtype)
        return out32.reshape(b, h, sl, d).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q32, pos_q, kv, out32, lse = ctx.saved_tensors
        group = ctx.group
        n, r = group.nranks, group.rank
        (b, h, sl, d), q_dt, k_dt, v_dt = ctx.shapes
        do32 = dout.float().reshape(out32.shape)
        d_rows = (do32 * out32).sum(dim=-1)
        dq = torch.zeros_like(q32)
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
        # the block held last came from rank (r - (n - 1)) % n: walk the
        # hops back, each block (and its dK / dV) toward its owner
        for step in range(n - 1, -1, -1):
            src = (r - step) % n
            dq, dk, dv = bwd_hop(q32, do32, lse, d_rows, kv[0], kv[1],
                                 dkv[0], dkv[1], dq, pos_q, src * sl,
                                 ctx.causal, ctx.window)
            dkv = torch.stack([dk, dv])
            if step > 0:
                kv = _exchange(kv, group, (r - 1) % n, (r + 1) % n)
                dkv = _exchange(dkv, group, (r - 1) % n, (r + 1) % n)
        dq = (dq * ctx.scale).reshape(b, h, sl, d).to(q_dt)
        return dq, dkv[0].to(k_dt), dkv[1].to(v_dt), None, None, None, None


def _sep_group(mesh, axis, group=None):
    if group is not None:
        return group if group.nranks > 1 else None
    from ..distributed import mesh as mesh_mod
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    if mesh is None or axis not in mesh.axis_names \
            or mesh.shape[axis] <= 1:
        return None
    return mesh.group(axis)


def ring_attention_arrays(q, k, v, mesh=None, axis: str = "sep",
                          causal: bool = False,
                          scale: Optional[float] = None,
                          window: Optional[int] = None, group=None):
    """Exact attention with the sequence split over ``axis``.

    q, k, v: this rank's chunks [b, h, s / n, d] (k / v may carry fewer
    heads, h_kv dividing h: GQA), rank r of the axis's group holding
    positions [r s / n, (r + 1) s / n). Differentiable in q, k and v.
    ``window``: sliding-window attention (requires ``causal=True``,
    like the flash entry). ``mesh``: the rank mesh (the global one by
    default); with the axis's degree <= 1 the port's flash entry runs.
    ``group``: the sep group itself, in place of ``mesh`` and ``axis``
    (a model passes the one it was built with)."""
    n_group = _sep_group(mesh, axis, group)
    n = 1 if n_group is None else n_group.nranks
    if window is not None:
        window = int(window)
        if not causal:
            raise ValueError("ring attention window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if n <= 1:
        # flash_attention_arrays takes paddle layout [B, S, H, D]; we are
        # [B, H, S, D] here
        from .flash_attention import flash_attention_arrays
        out = flash_attention_arrays(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, scale=scale, window=window)
        return out.transpose(1, 2)
    if k.shape[1] != v.shape[1] or k.shape[1] < 1 \
            or q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"GQA requires query heads ({q.shape[1]}) to be a multiple "
            f"of key/value heads ({k.shape[1]}, v {v.shape[1]})")
    if k.shape[2] != q.shape[2] or v.shape[2] != q.shape[2]:
        raise ValueError(
            f"ring attention takes equal chunks of q, k and v, got "
            f"{q.shape[2]}, {k.shape[2]}, {v.shape[2]}")
    return _RingAttention.apply(q, k, v, n_group, bool(causal), float(scale),
                                window)


def ring_flash_attention(query, key, value, causal=False, scale=None,
                         axis="sep", window=None, group=None):
    """Tensor-level API ([b, s / n, h, d] like paddle flash_attention;
    transposed internally to [b, h, s / n, d]); ``group`` as
    ``ring_attention_arrays``'."""
    from ..core.dispatch import surface

    def fn(q, k, v):
        out = ring_attention_arrays(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), axis=axis,
                                    causal=causal, scale=scale,
                                    window=window, group=group)
        return out.transpose(1, 2)

    return surface("ring_flash_attention", fn, [query, key, value])

