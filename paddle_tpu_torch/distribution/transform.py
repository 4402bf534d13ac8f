"""Probability transforms (counterpart of
``paddle_tpu/distribution/transform.py``; the reference's
python/paddle/distribution/transform.py): ``Transform`` and its 12
bijectors and injections. ``forward``, ``inverse`` and the log-det
Jacobians are ``run_op``s over the torch-level ``_forward`` /
``_inverse`` / ``_forward_log_det_jacobian``, differentiable in their
input, with the JAX package's formulas."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.dispatch import run_op, unwrap

__all__ = [
    "Transform", "AbsTransform", "AffineTransform", "ChainTransform",
    "ExpTransform", "IndependentTransform", "PowerTransform",
    "ReshapeTransform", "SigmoidTransform", "SoftmaxTransform",
    "StackTransform", "StickBreakingTransform", "TanhTransform",
]


def _const(x):
    x = unwrap(x)
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(x)


def _on(c, ref):
    return c.to(ref.device) if isinstance(c, torch.Tensor) else c


class Transform:
    """The base transform."""

    _event_rank = 0

    def forward(self, x):
        return run_op(type(self).__name__ + "_fwd", self._forward, [x])

    def inverse(self, y):
        return run_op(type(self).__name__ + "_inv", self._inverse, [y])

    def forward_log_det_jacobian(self, x):
        return run_op(type(self).__name__ + "_fldj",
                      self._forward_log_det_jacobian, [x])

    def inverse_log_det_jacobian(self, y):
        def fn(yv):
            return -self._forward_log_det_jacobian(self._inverse(yv))
        return run_op(type(self).__name__ + "_ildj", fn, [y])

    def forward_shape(self, shape):
        return tuple(shape)

    def inverse_shape(self, shape):
        return tuple(shape)

    def __call__(self, x):
        return self.forward(x)

    # subclasses implement the torch-level versions
    def _forward(self, x):
        raise NotImplementedError

    def _inverse(self, y):
        raise NotImplementedError

    def _forward_log_det_jacobian(self, x):
        raise NotImplementedError


class AbsTransform(Transform):
    def _forward(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y  # the principal branch, as in the reference


class AffineTransform(Transform):
    def __init__(self, loc, scale):
        self.loc = _const(loc)
        self.scale = _const(scale)

    def _forward(self, x):
        return _on(self.loc, x) + _on(self.scale, x) * x

    def _inverse(self, y):
        return (y - _on(self.loc, y)) / _on(self.scale, y)

    def _forward_log_det_jacobian(self, x):
        s = _on(self.scale, x)
        return torch.log(torch.abs(s)).to(x.dtype).expand(x.shape)


class ExpTransform(Transform):
    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _forward_log_det_jacobian(self, x):
        return x


class PowerTransform(Transform):
    def __init__(self, power):
        self.power = _const(power)

    def _forward(self, x):
        return torch.pow(x, _on(self.power, x))

    def _inverse(self, y):
        return torch.pow(y, 1.0 / _on(self.power, y))

    def _forward_log_det_jacobian(self, x):
        p = _on(self.power, x)
        return torch.log(torch.abs(p * torch.pow(x, p - 1)))


class SigmoidTransform(Transform):
    def _forward(self, x):
        return torch.sigmoid(x)

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _forward_log_det_jacobian(self, x):
        return -F.softplus(-x) - F.softplus(x)


class TanhTransform(Transform):
    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.atanh(y)

    def _forward_log_det_jacobian(self, x):
        # log(1 - tanh(x)^2) = 2 (log 2 - x - softplus(-2x))
        return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class SoftmaxTransform(Transform):
    """x -> softmax(x) over the last axis (not bijective: the inverse is
    the log, a left inverse, as in the reference)."""

    _event_rank = 1

    def _forward(self, x):
        return torch.softmax(x, dim=-1)

    def _inverse(self, y):
        return torch.log(y)


class ReshapeTransform(Transform):
    def __init__(self, in_event_shape, out_event_shape):
        self.in_event_shape = tuple(int(s) for s in in_event_shape)
        self.out_event_shape = tuple(int(s) for s in out_event_shape)
        self._event_rank = len(self.in_event_shape)

    def _forward(self, x):
        batch = x.shape[:x.dim() - len(self.in_event_shape)]
        return x.reshape(tuple(batch) + self.out_event_shape)

    def _inverse(self, y):
        batch = y.shape[:y.dim() - len(self.out_event_shape)]
        return y.reshape(tuple(batch) + self.in_event_shape)

    def _forward_log_det_jacobian(self, x):
        batch = x.shape[:x.dim() - len(self.in_event_shape)]
        return x.new_zeros(batch)

    def forward_shape(self, shape):
        k = len(self.in_event_shape)
        return tuple(shape[:-k]) + self.out_event_shape

    def inverse_shape(self, shape):
        k = len(self.out_event_shape)
        return tuple(shape[:-k]) + self.in_event_shape


def _stick_offset(k, ref):
    return torch.log(torch.arange(k, 0, -1, dtype=ref.dtype,
                                  device=ref.device))


def _lead(cum):
    return torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], dim=-1)


class StickBreakingTransform(Transform):
    """Unconstrained R^k -> the open (k+1)-simplex."""

    _event_rank = 1

    def _forward(self, x):
        z = torch.sigmoid(x - _stick_offset(x.shape[-1], x))
        cum = torch.cumprod(1 - z, dim=-1)
        return torch.cat([z * _lead(cum), cum[..., -1:]], dim=-1)

    def _inverse(self, y):
        k = y.shape[-1] - 1
        cum = 1 - torch.cumsum(y[..., :-1], dim=-1)
        z = y[..., :-1] / torch.clamp_min(_lead(cum), 1e-30)
        return torch.log(z) - torch.log1p(-z) + _stick_offset(k, y)

    def _forward_log_det_jacobian(self, x):
        # a triangular Jacobian: det = prod_i sigmoid'(t_i) * lead_i
        t = x - _stick_offset(x.shape[-1], x)
        z = torch.sigmoid(t)
        cum = torch.cumprod(1 - z, dim=-1)
        return torch.sum(-F.softplus(t) - F.softplus(-t)
                         + torch.log(torch.clamp_min(_lead(cum), 1e-30)),
                         dim=-1)

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def inverse_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)


class ChainTransform(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def _forward(self, x):
        for t in self.transforms:
            x = t._forward(x)
        return x

    def _inverse(self, y):
        for t in reversed(self.transforms):
            y = t._inverse(y)
        return y

    def _forward_log_det_jacobian(self, x):
        total = 0.0
        for t in self.transforms:
            total = total + t._forward_log_det_jacobian(x)
            x = t._forward(x)
        return total


class IndependentTransform(Transform):
    """Reinterprets the last batch dims of a base transform as event dims
    (the log-det summed over them)."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self.reinterpreted_batch_rank = int(reinterpreted_batch_rank)

    def _forward(self, x):
        return self.base._forward(x)

    def _inverse(self, y):
        return self.base._inverse(y)

    def _forward_log_det_jacobian(self, x):
        ldj = self.base._forward_log_det_jacobian(x)
        k = self.reinterpreted_batch_rank
        return torch.sum(ldj, dim=tuple(range(ldj.dim() - k, ldj.dim())))


class StackTransform(Transform):
    """One transform a slice along ``axis``."""

    def __init__(self, transforms, axis=0):
        self.transforms = list(transforms)
        self.axis = axis

    def _map(self, fn_name, v):
        parts = torch.chunk(v, len(self.transforms), dim=self.axis)
        outs = [getattr(t, fn_name)(pv.squeeze(self.axis))
                for t, pv in zip(self.transforms, parts)]
        return torch.stack(outs, dim=self.axis)

    def _forward(self, x):
        return self._map("_forward", x)

    def _inverse(self, y):
        return self._map("_inverse", y)

    def _forward_log_det_jacobian(self, x):
        return self._map("_forward_log_det_jacobian", x)
