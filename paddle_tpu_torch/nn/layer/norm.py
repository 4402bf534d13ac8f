"""Norm layers (counterpart of ``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import numpy as np

from ...core.tensor import Tensor
from .. import functional as F
from .. import initializer as I
from .layers import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                self._normalized_shape, attr=weight_attr,
                default_initializer=I.Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    """LLaMA-family norm; not in the reference snapshot as a layer but part
    of fused_rms_norm (incubate) — first-class here for the TPU models."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            list(normalized_shape), attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([num_features], attr=bias_attr,
                                              is_bias=True)
        self.register_buffer("_mean",
                             Tensor(np.zeros(num_features, np.float32)))
        self.register_buffer("_variance",
                             Tensor(np.ones(num_features, np.float32)))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Single-program SPMD: under pjit the batch axis is global, so plain
    batch statistics ARE the sync'd statistics — XLA inserts the cross-chip
    reductions (contrast with the reference's manual SyncBatchNorm kernel,
    nn/layer/norm.py:1371)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format)
            if layer.weight is not None:
                out.weight = layer.weight
            if layer.bias is not None:
                out.bias = layer.bias
            out._mean = layer._mean
            out._variance = layer._variance
        for name, sub in list(layer._sub_layers.items()):
            converted = cls.convert_sync_batchnorm(sub)
            if converted is not sub:
                layer._sub_layers[name] = converted
        return out


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                [num_channels], attr=weight_attr,
                default_initializer=I.Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """Normalise a weight by its largest singular value, estimated with
    persistent power-iteration vectors (reference: nn.SpectralNorm —
    forward(weight) -> weight / sigma)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        import numpy as np

        from ...core.tensor import to_tensor
        self.dim = dim
        self.power_iters = power_iters
        self.epsilon = epsilon
        shape = [int(s) for s in weight_shape]
        h = shape[dim]
        w = int(np.prod(shape)) // h
        rng = np.random.default_rng(0)
        self.register_buffer(
            "weight_u", to_tensor(_l2norm_np(rng.standard_normal(h))))
        self.register_buffer(
            "weight_v", to_tensor(_l2norm_np(rng.standard_normal(w))))

    def forward(self, weight):
        import torch

        from ...core.dispatch import run_op, unwrap
        dim, eps, iters = self.dim, self.epsilon, self.power_iters
        u0 = unwrap(self.weight_u)
        v0 = unwrap(self.weight_v)

        def fn(w):
            wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
            u, v = u0.to(wm.dtype), v0.to(wm.dtype)
            for _ in range(max(iters, 1)):
                v = wm.T @ u
                v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
                u = wm @ v
                u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
            sigma = u @ wm @ v
            return w / torch.clamp(sigma, min=eps), u, v
        out, u_new, v_new = run_op("spectral_norm_layer", fn, [weight])
        self.weight_u._data = unwrap(u_new).detach()
        self.weight_v._data = unwrap(v_new).detach()
        return out


def _l2norm_np(a):
    import numpy as np
    a = a.astype(np.float32)
    return a / max(float(np.linalg.norm(a)), 1e-12)
