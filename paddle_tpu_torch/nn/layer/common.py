"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``)."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class Dropout(nn.Module):
    """``F.dropout`` as a module, active in ``train()`` mode. Its masks
    come from ``generator`` (the owning model's ``torch.Generator``; the
    default generator when None)."""

    def __init__(self, p=0.5, mode="upscale_in_train", generator=None):
        super().__init__()
        self.p = p
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.mode, self.generator)
