"""Fused-op subset of the LLaMA path (counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py:92``
``fused_rotary_position_embedding``)."""
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
