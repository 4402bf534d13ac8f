"""Normalization functionals (counterpart of ``paddle_tpu/nn/functional/norm.py``).

Each takes surface Tensors (through ``run_op``) or raw torch tensors
(the same body, raw out). ``layer_norm`` and ``rms_norm`` keep the JAX
package's order of roundings, so that a bf16 result is the JAX one bit
for bit. ``batch_norm`` in training updates the running-statistics
tensors in place, as the JAX one rebinds them.
"""
from __future__ import annotations

import torch

from ...core.dispatch import surface, unwrap


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def fn(a):
        if p == 2:
            n = torch.sqrt(torch.sum(a * a, dim=axis, keepdim=True))
        else:
            n = torch.sum(torch.abs(a) ** p, dim=axis,
                          keepdim=True) ** (1. / p)
        return a / torch.clamp(n, min=epsilon)
    return surface("normalize", fn, [x])


def _layer_norm(x, weight, bias, normalized_shape, epsilon):
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    out = (x - mean.to(x.dtype)) / torch.sqrt(var.to(x.dtype) + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` dims in the JAX
    package's order of roundings: the mean in f32 rounded to x's dtype,
    the variance of the f32-centred values in f32 rounded to x's dtype,
    then ``(x - mean) / sqrt(var + eps)``, ``* weight`` and ``+ bias`` in
    x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return surface("layer_norm", _layer_norm, [x, weight, bias],
                   normalized_shape=list(normalized_shape), epsilon=epsilon)


def _rms_norm(x, weight, epsilon):
    ms = x.float().square().mean(dim=-1, keepdim=True)
    out = x * torch.reciprocal(torch.sqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm: the mean square in f32, x times ``rsqrt(ms + eps)`` cast
    to x's dtype, then times ``weight``."""
    return surface("rms_norm", _rms_norm, [x, weight], epsilon=epsilon)


def _channel_axis(a, data_format):
    return a.dim() - 1 if data_format in ("NHWC", "NDHWC", "NLC") else 1


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch statistics in training (then ``running = momentum * running
    + (1 - momentum) * batch_stat``, the variance unbiased, written in
    place), the running ones otherwise. The gradient treats the batch
    statistics as constants, as the JAX package's eager tape does (it
    computes them outside its op), except inside ``jit.functional_call``
    (``TrainStep``), where it runs through them as ``jax.grad`` does in
    the JAX ``TrainStep``."""
    a = unwrap(x)
    ch = _channel_axis(a, data_format)
    axes = tuple(i for i in range(a.dim()) if i != ch)
    use_batch = training and not use_global_stats
    traced = False
    if use_batch:
        from ...jit import functional as jit_functional
        traced = jit_functional.in_functional_call()
    if use_batch:
        with torch.no_grad():
            n = a.numel() // a.shape[ch]
            bvar = a.detach().var(dim=axes, unbiased=False)
            rm, rv = unwrap(running_mean), unwrap(running_var)
            rm.mul_(momentum).add_((1 - momentum) * a.detach().mean(
                dim=axes).to(rm.dtype))
            rv.mul_(momentum).add_((1 - momentum) * (
                bvar * (n / max(n - 1, 1))).to(rv.dtype))

    def fn(v, m, s, w, b):
        shape = [1] * v.dim()
        shape[ch] = v.shape[ch]
        if use_batch:
            # eager: the statistics as constants, as the JAX package wraps
            # them outside its op (no gradient through the batch mean /
            # var); traced: differentiated, as under jax.grad
            stat = v if traced else v.detach()
            m = stat.mean(dim=axes)
            s = stat.var(dim=axes, unbiased=False)
        out = (v - m.reshape(shape)) / torch.sqrt(s.reshape(shape) + epsilon)
        if w is not None:
            out = out * w.reshape(shape)
        if b is not None:
            out = out + b.reshape(shape)
        return out.to(v.dtype)
    return surface("batch_norm", fn, [x, running_mean, running_var, weight,
                                      bias])


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    def fn(a, w, b):
        axes = tuple(range(2, a.dim()))
        mean = a.mean(dim=axes, keepdim=True)
        var = a.var(dim=axes, unbiased=False, keepdim=True)
        out = (a - mean) / torch.sqrt(var + eps)
        shape = (1, -1) + (1,) * (a.dim() - 2)
        if w is not None:
            out = out * w.reshape(shape)
        if b is not None:
            out = out + b.reshape(shape)
        return out.to(a.dtype)
    return surface("instance_norm", fn, [x, weight, bias])


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    channel_last = data_format in ("NHWC", "NDHWC", "NLC")

    def fn(a, w, b):
        a_t = torch.movedim(a, -1, 1) if channel_last else a
        n, c = a_t.shape[:2]
        sp = a_t.shape[2:]
        g = a_t.reshape(n, num_groups, c // num_groups, *sp)
        axes = tuple(range(2, g.dim()))
        mean = g.mean(dim=axes, keepdim=True)
        var = g.var(dim=axes, unbiased=False, keepdim=True)
        out = ((g - mean) / torch.sqrt(var + epsilon)).reshape(a_t.shape)
        shape = (1, c) + (1,) * len(sp)
        if w is not None:
            out = out * w.reshape(shape)
        if b is not None:
            out = out + b.reshape(shape)
        if channel_last:
            out = torch.movedim(out, 1, -1)
        return out.to(a.dtype)
    return surface("group_norm", fn, [x, weight, bias])


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    def fn(a):
        ch = 1 if data_format.startswith("NC") else a.dim() - 1
        sq = torch.movedim(torch.square(a), ch, -1)
        half = size // 2
        padded = torch.nn.functional.pad(sq, (half, size - half - 1))
        win = sum(padded[..., i:i + a.shape[ch]] for i in range(size))
        return a / torch.movedim((k + alpha * win) ** beta, -1, ch)
    return surface("local_response_norm", fn, [x])
