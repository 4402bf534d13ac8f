"""Conv layers (counterpart of ``paddle_tpu/nn/layer/conv.py``): the
JAX layers' weight names, shapes ([out, in/groups, *k]; [in,
out/groups, *k] transposed) and initializers (weights N(0, 2 / fan_in),
biases zero) over the port's ``nn.functional`` convolutions."""
from __future__ import annotations

import numpy as np

from .. import functional as F
from .. import initializer as I
from .layers import Layer


def _ntuple(v, n):
    return [v] * n if isinstance(v, int) else list(v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", transpose=False, output_padding=0):
        super().__init__()
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, nd)
        self._stride = _ntuple(stride, nd)
        self._padding = padding
        self._dilation = _ntuple(dilation, nd)
        self._groups = groups
        self._data_format = data_format
        self._nd = nd
        self._transpose = transpose
        self._output_padding = output_padding
        if transpose:
            wshape = [in_channels, out_channels // groups] + \
                self._kernel_size
        else:
            wshape = [out_channels, in_channels // groups] + \
                self._kernel_size
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        std = (2.0 / max(fan_in, 1)) ** 0.5  # msra-ish default like paddle
        self.weight = self.create_parameter(
            wshape, attr=weight_attr, default_initializer=I.Normal(0.0, std))
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)
