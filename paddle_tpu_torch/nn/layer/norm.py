"""Normalization layers (counterpart of ``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F


class LayerNorm(nn.Module):
    """``F.layer_norm`` with a learned ``weight`` (ones) and ``bias``
    (zeros) over ``normalized_shape``."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)
