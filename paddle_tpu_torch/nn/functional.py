"""nn.functional subset of the LLaMA path (counterparts of
``paddle_tpu/nn/functional/norm.py:47`` ``rms_norm`` and
``activation.silu``)."""
from __future__ import annotations

import torch


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
