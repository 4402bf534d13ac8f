"""The ``torch.nn.Module``s the port's models are built from: ``LayerNorm``,
``Dropout`` and ``CrossEntropyLoss`` over raw torch tensors (BERT,
ERNIE-MoE and LLaMA training, ``profile_*``). They are private: the
public ``nn.LayerNorm``, ``nn.Dropout`` and ``nn.CrossEntropyLoss`` are
the eager surface's paddle ``Layer``s. Both call the same
``nn.functional`` bodies, so the numbers are the same.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F


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
        return F.dropout(x, self.p, training=self.training, mode=self.mode,
                         generator=self.generator)


class CrossEntropyLoss(nn.Module):
    """``F.cross_entropy`` as a module (counterpart of ``CrossEntropyLoss``
    at ``paddle_tpu/nn/layer/loss.py:8``)."""

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
