"""nn.utils (counterpart of ``paddle_tpu/nn/utils/__init__.py``):
parameter <-> vector, weight and spectral normalization as forward
pre-hooks, and the gradient clips.

``vector_to_parameters`` writes each parameter's leaf in place, so an
optimizer made before still holds it. ``weight_norm`` and
``spectral_norm`` compute the weight with surface ops, so gradients reach
``<name>_g`` / ``<name>_v`` (weight norm) and ``<name>_orig`` (spectral
norm; the power-iteration vectors are constants).
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.dispatch import run_op
from ...core.tensor import Tensor
from ..clip import clip_grad_norm_  # noqa: F401


def parameters_to_vector(parameters, name=None):
    return run_op("parameters_to_vector",
                  lambda *a: torch.cat([x.reshape(-1) for x in a]),
                  list(parameters))


def vector_to_parameters(vec, parameters, name=None):
    a = vec._data if isinstance(vec, Tensor) else torch.as_tensor(vec)
    off = 0
    with torch.no_grad():
        for p in parameters:
            d = p._data
            n = d.numel()
            d.copy_(a[off:off + n].reshape(d.shape).to(d.dtype))
            off += n


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize weight = g * v / ||v||, the norm over every axis but
    ``dim`` (paddle's nn/utils/weight_norm_hook.py)."""
    from ...framework.param_attr import Parameter
    w = getattr(layer, name)
    arr = w._data.detach()
    axes = tuple(i for i in range(arr.dim()) if i != dim)
    g = torch.sqrt(torch.sum(torch.square(arr), dim=axes))
    layer.add_parameter(name + "_g", Parameter(g))
    layer.add_parameter(name + "_v", Parameter(arr.clone()))
    del layer._parameters[name]
    shape = [1] * arr.dim()
    shape[dim] = -1

    def normed(v, gg):
        norm = torch.sqrt(torch.sum(torch.square(v), dim=axes,
                                    keepdim=True))
        return v / torch.clamp(norm, min=1e-12) * gg.reshape(shape)

    def hook(lyr, inputs):
        wt = run_op("weight_norm", normed, [getattr(lyr, name + "_v"),
                                            getattr(lyr, name + "_g")])
        object.__setattr__(lyr, "_wn_cached", wt)
        lyr._parameters[name] = None   # read through the attribute below
        object.__setattr__(lyr, name, wt)
    layer.register_forward_pre_hook(hook)
    return layer


def remove_weight_norm(layer, name="weight"):
    v = getattr(layer, name + "_v")
    layer._parameters.pop(name + "_g", None)
    layer._parameters.pop(name + "_v", None)
    layer._parameters[name] = v
    layer._forward_pre_hooks.clear()
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Power-iteration spectral normalization applied as a pre-hook; u
    starts from ``np.random.default_rng(0)``, as in the JAX package."""
    if dim is None:
        dim = 0
    w = getattr(layer, name)
    h = w._data.shape[dim]
    u = np.random.default_rng(0).standard_normal(h).astype(np.float32)
    state = {"u": torch.as_tensor(u / np.linalg.norm(u),
                                  device=w._data.device)}

    def normalized(wt):
        mat = torch.movedim(wt, dim, 0).reshape(wt.shape[dim], -1)
        with torch.no_grad():
            u_ = state["u"]
            for _ in range(n_power_iterations):
                v_ = mat.T @ u_
                v_ = v_ / torch.clamp(torch.linalg.norm(v_), min=eps)
                u_ = mat @ v_
                u_ = u_ / torch.clamp(torch.linalg.norm(u_), min=eps)
            state["u"] = u_
        sigma = u_ @ mat @ v_
        return wt / torch.clamp(sigma, min=eps)

    def hook(lyr, inputs):
        orig = lyr.__dict__.get(name + "_orig")
        if orig is None:
            orig = lyr._parameters[name]
            object.__setattr__(lyr, name + "_orig", orig)
        object.__setattr__(lyr, name, run_op("spectral_norm", normalized,
                                             [orig]))
        lyr._parameters[name] = None
    layer.register_forward_pre_hook(hook)
    return layer


def clip_grad_value_(parameters, clip_value):
    """Clamp gradients elementwise into [-clip_value, clip_value] in
    place."""
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    cv = float(clip_value)
    with torch.no_grad():
        for p in parameters:
            if p.grad is not None:
                p.grad._data.clamp_(-cv, cv)
    return parameters


__all__ = ["clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "remove_weight_norm", "spectral_norm", "vector_to_parameters",
           "weight_norm"]
