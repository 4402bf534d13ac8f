"""FLOPs counting for dygraph Layers (counterpart of
``paddle_tpu/hapi/dynamic_flops.py``; reference:
python/paddle/hapi/dynamic_flops.py:40 flops()).

Counts multiply-accumulates as 2 FLOPs = 1 MAC pair the same way the
reference does (it reports MACs-style totals per layer via per-type count
hooks), using forward-post hooks over one traced forward pass.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn


def _count_linear(layer, inputs, output):
    x = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
    in_f = int(x.shape[-1])
    out_n = int(np.prod(output.shape))
    return out_n * in_f


def _count_conv(layer, inputs, output):
    w = layer.weight
    kernel_ops = int(np.prod(w.shape[1:]))  # in_ch/groups * k
    out_n = int(np.prod(output.shape))
    return out_n * kernel_ops


def _count_norm(layer, inputs, output):
    return 2 * int(np.prod(output.shape))


def _count_act(layer, inputs, output):
    return int(np.prod(output.shape))


def _count_pool(layer, inputs, output):
    return int(np.prod(output.shape))


_COUNT_FNS = []


def _register_defaults():
    pairs = [
        ("Linear", _count_linear), ("Conv1D", _count_conv),
        ("Conv2D", _count_conv), ("Conv3D", _count_conv),
        ("Conv2DTranspose", _count_conv),
        ("BatchNorm", _count_norm), ("BatchNorm1D", _count_norm),
        ("BatchNorm2D", _count_norm), ("BatchNorm3D", _count_norm),
        ("LayerNorm", _count_norm), ("GroupNorm", _count_norm),
        ("ReLU", _count_act), ("ReLU6", _count_act), ("GELU", _count_act),
        ("Sigmoid", _count_act), ("Softmax", _count_act),
        ("AvgPool2D", _count_pool), ("MaxPool2D", _count_pool),
        ("AdaptiveAvgPool2D", _count_pool), ("AdaptiveMaxPool2D", _count_pool),
    ]
    for name, fn in pairs:
        cls = getattr(nn, name, None)
        if cls is not None:
            _COUNT_FNS.append((cls, fn))


_register_defaults()


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Count one forward pass' FLOPs for `net` on zeros of `input_size`.

    custom_ops: {LayerClass: fn(layer, inputs, output) -> flops} overrides.
    Returns the total as an int (reference hapi.dynamic_flops.flops).
    """
    from .. import zeros

    custom = list((custom_ops or {}).items())
    records = []
    handles = []

    def make_hook(layer, fn):
        def hook(lyr, inputs, output):
            out = output[0] if isinstance(output, (tuple, list)) else output
            n = int(fn(lyr, inputs, out))
            records.append((type(lyr).__name__, lyr.full_name()
                            if hasattr(lyr, "full_name") else "", n))
        return hook

    for lyr in net.sublayers(include_self=True):
        fn = None
        for cls, f in custom:
            if isinstance(lyr, cls):
                fn = f
                break
        if fn is None:
            for cls, f in _COUNT_FNS:
                if type(lyr) is cls:
                    fn = f
                    break
        if fn is not None:
            handles.append(lyr.register_forward_post_hook(make_hook(lyr, fn)))

    was_training = net.training
    net.eval()
    try:
        x = zeros(list(input_size), "float32")
        with torch.no_grad():
            net(x)
    finally:
        for h in handles:
            h.remove()
        if was_training:
            net.train()

    total = sum(n for _, _, n in records)
    if print_detail:
        print(f"{'Layer':<24}{'FLOPs':>16}")
        for name, full, n in records:
            print(f"{name:<24}{n:>16,}")
        print(f"{'Total':<24}{total:>16,}")
    return total
