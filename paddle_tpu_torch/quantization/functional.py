"""KV-cache int8 quantization (counterpart of
``paddle_tpu/quantization/functional.py`` ``kv_quantize_arrays`` and
``kv_dequantize_arrays``)."""
from __future__ import annotations

import torch


def kv_quantize_arrays(x: torch.Tensor, bound: float = 127.0):
    """Symmetric int8 quantization of a KV chunk along its LAST axis
    (head_dim): one scale per (token, kv_head), so a new token's absmax
    never rescales entries already written.

    x: [..., d] float -> (q int8 [..., d], scale f32 [...]).
    """
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / bound
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -bound, bound)
    return q.to(torch.int8), scale


def kv_dequantize_arrays(q: torch.Tensor, scale: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Inverse of kv_quantize_arrays: q int8 [..., d], scale [...] ->
    float [..., d], multiplied in f32."""
    return (q.float() * scale[..., None].float()).to(dtype)
