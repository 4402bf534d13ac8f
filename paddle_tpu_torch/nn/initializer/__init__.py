"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer``).

An initializer fills a parameter in place (under ``torch.no_grad()``)
with float32 draws from the port's generator of the parameter's device
(``core.random``), cast to the parameter's dtype. The JAX package's
threefry draws cannot be reproduced: the distributions match, the bits
do not.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core import random as random_mod
from ...core.tensor import Tensor


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0), "selu": 3.0 / 4.0,
    }
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity in gains:
        return gains[nonlinearity]
    raise ValueError(f"unsupported nonlinearity: {nonlinearity}")


class Initializer:
    def __call__(self, param: Tensor, block=None):
        raise NotImplementedError

    @staticmethod
    def _set(param, value: torch.Tensor):
        with torch.no_grad():
            param._data.copy_(value)
        return param

    @staticmethod
    def _draw(param, kind, *args):
        d = param._data
        out = torch.empty(d.shape, dtype=torch.float32, device=d.device)
        getattr(out, kind)(*args, generator=random_mod.generator(d.device))
        return out


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, param, block=None):
        with torch.no_grad():
            param._data.fill_(self.value)
        return param


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, param, block=None):
        return self._set(param, self._draw(param, "normal_", self.mean,
                                           self.std))


class TruncatedNormal(Initializer):
    """Truncated at [mean + a*std, mean + b*std] (default 2 std)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, param, block=None):
        d = param._data
        out = torch.empty(d.shape, dtype=torch.float32, device=d.device)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, self.a, self.b,
                                    generator=random_mod.generator(d.device))
        return self._set(param, out * self.std + self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, param, block=None):
        return self._set(param, self._draw(param, "uniform_", self.low,
                                           self.high))


def _fan_in_out(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # paddle's Linear weight layout is [in, out]
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param, block=None):
        fi, fo = _fan_in_out(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return self._set(param, self._draw(param, "normal_", 0.0, std))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param, block=None):
        fi, fo = _fan_in_out(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return self._set(param, self._draw(param, "uniform_", -limit, limit))


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain_over_fan(self, param):
        fi, _ = _fan_in_out(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope) \
            if self.nonlinearity == "leaky_relu" else \
            calculate_gain(self.nonlinearity)
        return gain, fi


class KaimingNormal(_Kaiming):
    def __call__(self, param, block=None):
        gain, fi = self._gain_over_fan(param)
        return self._set(param, self._draw(param, "normal_", 0.0,
                                           gain / math.sqrt(fi)))


class KaimingUniform(_Kaiming):
    def __call__(self, param, block=None):
        gain, fi = self._gain_over_fan(param)
        limit = gain * math.sqrt(3.0 / fi)
        return self._set(param, self._draw(param, "uniform_", -limit, limit))


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, param, block=None):
        v = self.value
        v = v._data if isinstance(v, Tensor) else torch.as_tensor(
            np.asarray(v))
        if tuple(v.shape) != tuple(param.shape):
            raise ValueError(
                f"Assign initializer shape {tuple(v.shape)} does not match "
                f"parameter shape {tuple(param.shape)}")
        return self._set(param, v)


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, param, block=None):
        shape = param.shape
        if len(shape) < 2:
            raise ValueError("Orthogonal init needs >= 2 dims")
        rows, cols = shape[0], int(np.prod(shape[1:]))
        d = param._data
        flat = torch.empty(rows, cols, dtype=torch.float32, device=d.device)
        torch.nn.init.orthogonal_(flat, self.gain,
                                  generator=random_mod.generator(d.device))
        return self._set(param, flat.reshape(shape))


class Dirac(Initializer):
    """Identity-preserving conv init."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, param, block=None):
        shape = param.shape
        if len(shape) not in (3, 4, 5):
            raise ValueError("Dirac init expects conv weight (3/4/5-D)")
        arr = np.zeros(shape, np.float32)
        out_per_group = shape[0] // self.groups
        mid = [k // 2 for k in shape[2:]]
        for g in range(self.groups):
            for i in range(min(out_per_group, shape[1])):
                arr[(g * out_per_group + i, i, *mid)] = 1.0
        return self._set(param, torch.from_numpy(arr))


class Bilinear(Initializer):
    """Bilinear-upsampling stencil for a [C_out, C_in, k, k] weight."""

    def __call__(self, param, block=None):
        shape = param.shape
        if len(shape) != 4:
            raise ValueError("Bilinear expects a 4-D conv weight")
        k = shape[-1]
        f = int(np.ceil(k / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        og = np.ogrid[:k, :k]
        filt = (1 - np.abs(og[0] / f - c)) * (1 - np.abs(og[1] / f - c))
        w = np.zeros(shape, np.float32)
        w[...] = filt
        return self._set(param, torch.from_numpy(w))


ConstantInitializer = Constant
NormalInitializer = Normal
UniformInitializer = Uniform
XavierInitializer = XavierNormal
MSRAInitializer = KaimingNormal
NumpyArrayInitializer = Assign

_global_weight_initializer = None
_global_bias_initializer = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_initializer, _global_bias_initializer
    _global_weight_initializer = weight_init
    _global_bias_initializer = bias_init


def global_weight_initializer():
    return _global_weight_initializer


def global_bias_initializer():
    return _global_bias_initializer
