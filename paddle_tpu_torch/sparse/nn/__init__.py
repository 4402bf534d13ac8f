"""paddle.sparse.nn of the port (counterpart of
``paddle_tpu/sparse/nn/__init__.py``): Layers over the sparse
functionals."""
from __future__ import annotations

from ...nn import Layer
from . import functional

__all__ = ["ReLU", "ReLU6", "LeakyReLU", "Softmax", "Conv2D", "Conv3D",
           "SubmConv2D", "SubmConv3D", "MaxPool3D", "BatchNorm",
           "SyncBatchNorm", "functional"]


class ReLU(Layer):
    def forward(self, x):
        return functional.relu(x)


class Softmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return functional.softmax(x, self.axis)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return functional.leaky_relu(x, self.negative_slope)


class ReLU6(Layer):
    def forward(self, x):
        return functional.relu6(x)


class _SparseConvBase(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd,
                 stride=1, padding=0, dilation=1, groups=1,
                 subm=False, weight_attr=None, bias_attr=None):
        super().__init__()
        ks = (kernel_size,) * nd if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *ks], attr=weight_attr)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True) \
            if bias_attr is not False else None
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self._nd, self._subm = nd, subm

    def forward(self, x):
        fn = {(2, False): functional.conv2d,
              (2, True): functional.subm_conv2d,
              (3, False): functional.conv3d,
              (3, True): functional.subm_conv3d}[(self._nd, self._subm)]
        return fn(x, self.weight, self.bias, self.stride, self.padding,
                  self.dilation, self.groups)


class Conv2D(_SparseConvBase):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NHWC"):
        super().__init__(in_channels, out_channels, kernel_size, 2,
                         stride, padding, dilation, groups, False,
                         weight_attr, bias_attr)


class Conv3D(_SparseConvBase):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NDHWC"):
        super().__init__(in_channels, out_channels, kernel_size, 3,
                         stride, padding, dilation, groups, False,
                         weight_attr, bias_attr)


class SubmConv2D(_SparseConvBase):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 key=None, weight_attr=None, bias_attr=None,
                 data_format="NHWC"):
        super().__init__(in_channels, out_channels, kernel_size, 2,
                         stride, padding, dilation, groups, True,
                         weight_attr, bias_attr)


class SubmConv3D(_SparseConvBase):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 key=None, weight_attr=None, bias_attr=None,
                 data_format="NDHWC"):
        super().__init__(in_channels, out_channels, kernel_size, 3,
                         stride, padding, dilation, groups, True,
                         weight_attr, bias_attr)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NDHWC", name=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding = padding

    def forward(self, x):
        return functional.max_pool3d(x, self.kernel_size, self.stride,
                                     self.padding)


class BatchNorm(Layer):
    """Sparse batch norm over the channel dim: values [nnz, C] are
    normalised as they are; a fully sparse layout (channels among the
    indices) is made dense, normalised over its last axis (the absent
    sites' zeros included, as in the JAX package) and made sparse
    again."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NDHWC",
                 use_global_stats=None, name=None):
        super().__init__()
        from ...nn import BatchNorm1D
        self._bn = BatchNorm1D(num_features, momentum=momentum,
                               epsilon=epsilon, weight_attr=weight_attr,
                               bias_attr=bias_attr)

    def forward(self, x):
        from ...core.dispatch import wrap
        from .. import _dense, _from_dense
        if x._vals.dim() == 1:
            dense = _dense(x)
            flat = dense.reshape(-1, dense.shape[-1])
            out = self._bn(wrap(flat))._data.reshape(dense.shape)
            return _from_dense(out)
        return x._with_values(self._bn(wrap(x._vals))._data)


class SyncBatchNorm(BatchNorm):
    """The same layer (one card: the statistics are already global)."""
