"""Loss layers (counterpart of ``paddle_tpu/nn/layer/loss.py``)."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class CrossEntropyLoss(nn.Module):
    """``F.cross_entropy`` as a module (counterpart of ``CrossEntropyLoss``
    at ``paddle_tpu/nn/layer/loss.py:8``): hard labels, ``ignore_index``,
    ``reduction``."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)
