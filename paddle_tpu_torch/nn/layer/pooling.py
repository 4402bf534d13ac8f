"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py``)
over the port's ``nn.functional`` pooling."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


class _Pool(Layer):
    def __init__(self, kernel_size=None, stride=None, padding=0,
                 ceil_mode=False, **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.kw = kw

    def extra_repr(self):
        return f"kernel_size={self.kernel_size}, stride={self.stride}"


class MaxPool1D(_Pool):
    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode, **self.kw)


class MaxPool2D(_Pool):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode, **self.kw)


class MaxPool3D(_Pool):
    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode, **self.kw)


class AvgPool1D(_Pool):
    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode, **self.kw)


class AvgPool2D(_Pool):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode, **self.kw)


class AvgPool3D(_Pool):
    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode, **self.kw)


class LPPool2D(_Pool):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, **kw):
        super().__init__(kernel_size, stride, padding, ceil_mode, **kw)
        self.norm_type = norm_type

    def forward(self, x):
        return F.lp_pool2d(x, self.norm_type, self.kernel_size, self.stride,
                           self.padding, self.ceil_mode)


class _AdaptivePool(Layer):
    def __init__(self, output_size, **kw):
        super().__init__()
        self.output_size = output_size
        self.kw = kw


class AdaptiveAvgPool1D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveAvgPool3D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool1D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, **self.kw)


class AdaptiveMaxPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, **self.kw)


class AdaptiveMaxPool3D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, **self.kw)


class LPPool1D(_Pool):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode=ceil_mode)
        self.norm_type = norm_type
        self.data_format = data_format

    def forward(self, x):
        return F.lp_pool1d(x, self.norm_type, self.kernel_size, self.stride,
                           self.padding, self.ceil_mode, self.data_format)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.data_format = padding, data_format
        self.output_size = output_size

    def forward(self, x, indices):
        return F.max_unpool1d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.data_format,
                              self.output_size)


class MaxUnPool2D(MaxUnPool1D):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.data_format,
                              self.output_size)


class MaxUnPool3D(MaxUnPool1D):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)

    def forward(self, x, indices):
        return F.max_unpool3d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.data_format,
                              self.output_size)


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size, self.kernel_size = output_size, kernel_size
        self.random_u, self.return_mask = random_u, return_mask

    def forward(self, x):
        return F.fractional_max_pool2d(x, self.output_size,
                                       self.kernel_size, self.random_u,
                                       self.return_mask)


class FractionalMaxPool3D(FractionalMaxPool2D):
    def forward(self, x):
        return F.fractional_max_pool3d(x, self.output_size,
                                       self.kernel_size, self.random_u,
                                       self.return_mask)
