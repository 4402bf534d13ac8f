"""Common layers: Linear, Embedding, Dropout, Flatten, Pad... (counterpart
of ``paddle_tpu/nn/layer/common.py``), with the vision layers (Upsample*,
Fold / Unfold, PixelShuffle / PixelUnshuffle, ChannelShuffle) over the
``nn.functional`` resize / fold / shuffle functionals."""
from __future__ import annotations

import torch

from .. import functional as F
from .layers import Layer


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):
        return input


class Linear(Layer):
    """y = xW + b, weight shape [in_features, out_features]
    (reference: nn/layer/common.py Linear)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr)
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, input):
        return F.linear(input, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Dropout(Layer):
    """``F.dropout`` in ``train()`` mode; its masks come from
    ``generator`` when one is given (a ``torch.Generator`` on the
    input's device), else from the port's generator of that device."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, input):
        return F.dropout(input, p=self.p, axis=self.axis,
                         training=self.training, mode=self.mode,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, input):
        return F.dropout2d(input, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, input):
        return F.dropout3d(input, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, input):
        return F.alpha_dropout(input, p=self.p, training=self.training)


class Embedding(Layer):
    """Reference: nn/layer/common.py Embedding; weight [num, dim]."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        from .. import initializer as I
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal())
        if padding_idx is not None:
            pi = padding_idx if padding_idx >= 0 \
                else num_embeddings + padding_idx
            with torch.no_grad():
                self.weight._data[pi] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, input):
        from ...ops import manipulation
        return manipulation.flatten(input, self.start_axis, self.stop_axis)


class _PadNd(Layer):
    def __init__(self, padding, mode, value, data_format):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    pass


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unflatten(Layer):
    """Expand one axis into a shape (reference: nn.Unflatten)."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, x):
        from ...ops import manipulation as M
        return M.unflatten(x, self.axis, self.shape)


class Softmax2D(Layer):
    """Softmax over the channel dim of NCHW/CHW inputs (reference:
    nn.Softmax2D)."""

    def forward(self, x):
        if len(x.shape) not in (3, 4):
            raise ValueError("Softmax2D expects 3D or 4D input")
        return F.softmax(x, axis=-3)


class ZeroPad1D(Layer):
    """Zero-pad the last dim; padding = [left, right] (reference:
    nn.ZeroPad1D)."""

    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        self.padding = [padding, padding] if isinstance(padding, int) \
            else list(padding)
        self.data_format = data_format

    def forward(self, x):
        from ...ops import manipulation as M
        l, r = self.padding
        nd = len(x.shape)
        cfg = [0] * (2 * nd)
        ax = nd - 1 if self.data_format == "NCL" else nd - 2
        cfg[2 * ax], cfg[2 * ax + 1] = l, r
        return M.pad(x, cfg)


class ZeroPad3D(Layer):
    """Zero-pad D/H/W dims; padding = [l, r, top, bottom, front, back]
    (reference: nn.ZeroPad3D)."""

    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__()
        self.padding = [padding] * 6 if isinstance(padding, int) \
            else list(padding)
        self.data_format = data_format

    def forward(self, x):
        return F.pad3d(x, self.padding, mode="constant", value=0.0,
                       data_format=self.data_format)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.feature_alpha_dropout(x, self.p, self.training)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon,
                                   self.keepdim)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)
