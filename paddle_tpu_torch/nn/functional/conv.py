"""Convolution functionals (counterpart of ``paddle_tpu/nn/functional/conv.py``).

The JAX package runs ``lax.conv_general_dilated``; the port runs torch's
``conv{1,2,3}d`` / ``conv_transpose{1,2,3}d`` (cuDNN on the card).
Paddle's weight layouts are torch's: [out, in/groups, *k] for a
convolution, [in, out/groups, *k] for a transposed one. Padding follows
the JAX op: an int, per-dim ints, per-dim (lo, hi) pairs or a flat
[lo0, hi0, lo1, hi1, ...] list, or "SAME" / "VALID" (lax's rule: SAME
puts the odd pad at the high end). torch takes symmetric pads only, so a
convolution pads with ``F.pad`` first (a negative pad crops). A
transposed convolution is torch's with no padding, then cropped by the
(lo, hi) pads and grown by ``output_padding`` at the high end, which is
the JAX gradient convolution's output; as there, a string padding on a
transposed convolution means no padding. Channels-last layouts
(``NLC`` / ``NHWC`` / ``NDHWC``) are permuted to channels-first and back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import surface, unwrap

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuple(v, n):
    if isinstance(v, (int, float)):
        return (int(v),) * n
    v = tuple(int(i) for i in v)
    if len(v) == 1:
        return v * n
    return v


def _padding(padding, nd):
    """paddle padding -> "SAME" / "VALID" or nd (lo, hi) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(int(q) for q in p) for p in padding]
    raise ValueError(f"bad padding {padding}")


def _same_pads(sizes, ksize, strides, dilations):
    """lax's SAME padding: output ceil(in / stride), the odd pad high."""
    pairs = []
    for n, k, s, d in zip(sizes, ksize, strides, dilations):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pairs.append((total // 2, total - total // 2))
    return pairs


def _to_first(a, channel_last):
    return torch.movedim(a, -1, 1) if channel_last else a


def _to_last(a, channel_last):
    return torch.movedim(a, 1, -1) if channel_last else a


def _flat_pad(pairs):
    """(lo, hi) pairs in dim order -> torch ``F.pad``'s last-dim-first list."""
    return [v for lo, hi in reversed(pairs) for v in (lo, hi)]


def _conv(name, x, weight, bias, stride, padding, dilation, groups,
          channel_last, nd):
    strides = _tuple(stride, nd)
    dilations = _tuple(dilation, nd)
    pad = _padding(padding, nd)

    def fn(a, w, *rest):
        a = _to_first(a, channel_last)
        if pad == "SAME":
            pairs = _same_pads(a.shape[2:], w.shape[2:], strides, dilations)
        elif pad == "VALID":
            pairs = [(0, 0)] * nd
        else:
            pairs = pad
        if any(lo or hi for lo, hi in pairs):
            a = TF.pad(a, _flat_pad(pairs))
        out = _CONV[nd](a, w, rest[0] if rest else None, strides, 0,
                        dilations, groups)
        return _to_last(out, channel_last)
    args = [x, weight] + ([bias] if bias is not None else [])
    return surface(name, fn, args)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv("conv1d", x, weight, bias, stride, padding, dilation,
                 groups, data_format == "NLC", 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv("conv2d", x, weight, bias, stride, padding, dilation,
                 groups, data_format == "NHWC", 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv("conv3d", x, weight, bias, stride, padding, dilation,
                 groups, data_format == "NDHWC", 3)


def _conv_transpose(name, x, weight, bias, stride, padding, output_padding,
                    dilation, groups, channel_last, nd, output_size=None):
    strides = _tuple(stride, nd)
    dilations = _tuple(dilation, nd)
    pad = _padding(padding, nd)
    pairs = [(0, 0)] * nd if isinstance(pad, str) else pad
    opad = _tuple(output_padding, nd)

    def fn(a, w, *rest):
        a = _to_first(a, channel_last)
        out = _CONV_T[nd](a, w, None, strides, 0, 0, groups, dilations)
        # the full output, cropped by the pads and grown by output_padding
        crop = [(-lo, op - hi) for (lo, hi), op in zip(pairs, opad)]
        if any(lo or hi for lo, hi in crop):
            out = TF.pad(out, _flat_pad(crop))
        if rest:
            out = out + rest[0].reshape((1, -1) + (1,) * nd)
        return _to_last(out, channel_last)
    args = [x, weight] + ([bias] if bias is not None else [])
    out = surface(name, fn, args)
    if output_size is not None:
        got = unwrap(out).shape
        sp = got[1:1 + nd] if channel_last else got[2:2 + nd]
        want = _tuple(output_size, nd)
        if tuple(sp) != tuple(want):
            raise ValueError(
                f"{name}: computed spatial size {tuple(sp)} != "
                f"requested output_size {tuple(want)}; adjust output_padding")
    return out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose("conv1d_transpose", x, weight, bias, stride,
                           padding, output_padding, dilation, groups,
                           data_format == "NLC", 1, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose("conv2d_transpose", x, weight, bias, stride,
                           padding, output_padding, dilation, groups,
                           data_format == "NHWC", 2, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose("conv3d_transpose", x, weight, bias, stride,
                           padding, output_padding, dilation, groups,
                           data_format == "NDHWC", 3, output_size)


def depthwise_conv2d(x, weight, bias=None, stride=1, padding=0,
                     dilation=1, data_format="NCHW", name=None):
    """groups == in_channels."""
    ch = unwrap(x).shape[1 if data_format == "NCHW" else -1]
    return conv2d(x, weight, bias=bias, stride=stride, padding=padding,
                  dilation=dilation, groups=ch, data_format=data_format)


def conv2d_transpose_bias(x, weight, bias, stride=1, padding=0,
                          output_padding=0, dilation=1, groups=1,
                          data_format="NCHW", name=None):
    return conv2d_transpose(x, weight, bias=bias, stride=stride,
                            padding=padding, output_padding=output_padding,
                            dilation=dilation, groups=groups,
                            data_format=data_format)


def depthwise_conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                               output_padding=0, groups=None, dilation=1,
                               output_size=None, data_format="NCHW",
                               name=None):
    """Transposed depthwise convolution: groups == in_channels."""
    ch = int(unwrap(x).shape[1 if data_format == "NCHW" else -1])
    return conv2d_transpose(x, weight, bias, stride, padding,
                            output_padding, groups or ch, dilation,
                            output_size, data_format)
