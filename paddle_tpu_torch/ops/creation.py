"""Tensor creation ops (counterpart of ``paddle_tpu/ops/creation.py``).

New tensors go to the current place (``core.place``; the GPU unless the
CPU was asked for); ``*_like`` ops follow their input's device. Random
ops draw from the port's generator of that device (``core.random``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ..core import random as random_mod
from ..core.dispatch import run_op, run_op_nodiff, unwrap, wrap
from ..core.tensor import Tensor, to_tensor  # noqa: F401  (re-export)


def _dt(dtype, default=None):
    if dtype is None:
        if default is None:
            return dtype_mod.default_float_dtype().torch_dtype
        return default if isinstance(default, torch.dtype) \
            else dtype_mod.to_torch(default)
    return dtype_mod.to_torch(dtype)


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.tolist()) if shape.ndim \
            else (int(shape.item()),)
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(unwrap(s)) for s in shape)


def _dev():
    return place_mod.current_device()


def _gen(device):
    return random_mod.generator(device)


def zeros(shape, dtype=None, name=None):
    return wrap(torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev()))


def ones(shape, dtype=None, name=None):
    return wrap(torch.ones(_shape(shape), dtype=_dt(dtype), device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    fill = unwrap(fill_value)
    if isinstance(fill, torch.Tensor):
        fill = fill.item()
    if dtype is None and isinstance(fill, (bool, int, float)):
        d = torch.bool if isinstance(fill, bool) else torch.int64 \
            if isinstance(fill, int) else _dt(None)
        return wrap(torch.full(_shape(shape), fill, dtype=d, device=_dev()))
    return wrap(torch.full(_shape(shape), fill, dtype=_dt(dtype),
                           device=_dev()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype, name)


def zeros_like(x, dtype=None, name=None):
    a = unwrap(x)
    return wrap(torch.zeros(a.shape, dtype=_dt(dtype, a.dtype),
                            device=a.device))


def ones_like(x, dtype=None, name=None):
    a = unwrap(x)
    return wrap(torch.ones(a.shape, dtype=_dt(dtype, a.dtype),
                           device=a.device))


def full_like(x, fill_value, dtype=None, name=None):
    a = unwrap(x)
    fill = unwrap(fill_value)
    if isinstance(fill, torch.Tensor):
        fill = fill.item()
    return wrap(torch.full(a.shape, fill, dtype=_dt(dtype, a.dtype),
                           device=a.device))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype, name)


def _scalar(v):
    v = unwrap(v)
    return v.item() if isinstance(v, torch.Tensor) else v


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dt = _dt(None) if any(isinstance(v, float)
                              for v in (start, end, step)) else torch.int64
    else:
        dt = _dt(dtype)
    return wrap(torch.arange(start, end, step, dtype=dt, device=_dev()))


def linspace(start, stop, num, dtype=None, name=None):
    return wrap(torch.linspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)), dtype=_dt(dtype),
                               device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return wrap(torch.logspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)), base=_scalar(base),
                               dtype=_dt(dtype), device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = int(num_columns) if num_columns is not None else n
    return wrap(torch.eye(n, m, dtype=_dt(dtype), device=_dev()))


def diag(x, offset=0, padding_value=0, name=None):
    def fn(a):
        out = torch.diag(a, offset)
        if a.dim() == 1 and padding_value != 0:
            keep = torch.diag(torch.ones_like(a, dtype=torch.bool), offset)
            out = torch.where(keep, out, torch.full_like(out, padding_value))
        return out
    # not differentiable, as the JAX package's (a plain wrap)
    return run_op_nodiff("diag", fn, [x])


def diagflat(x, offset=0, name=None):
    return run_op_nodiff("diagflat", lambda a: torch.diagflat(a, offset),
                         [x])


def tril(x, diagonal=0, name=None):
    return run_op("tril", lambda a: torch.tril(a, diagonal), [x])


def triu(x, diagonal=0, name=None):
    return run_op("triu", lambda a: torch.triu(a, diagonal), [x])


def tril_indices(row, col, offset=0, dtype="int64"):
    return wrap(torch.tril_indices(row, col, offset, device=_dev()).to(
        _dt(dtype, torch.int64)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = col if col is not None else row
    return wrap(torch.triu_indices(row, col, offset, device=_dev()).to(
        _dt(dtype, torch.int64)))


def meshgrid(*args, name=None):
    ts = list(args[0] if len(args) == 1 and isinstance(args[0],
                                                       (list, tuple))
              else args)
    return list(run_op_nodiff("meshgrid", lambda *a: tuple(
        torch.meshgrid(*a, indexing="ij")), ts))


def assign(x, output=None):
    """A copy of ``x`` with no graph back to it (``stop_gradient=True``),
    as the JAX package's new array; ``output`` is rebound to the copy."""
    a = x._data.detach().clone() if isinstance(x, Tensor) \
        else Tensor(x)._data
    if output is not None:
        output._data = a
        output._sg = True
        return output
    return wrap(a)


def clone(x, name=None):
    return run_op("clone", torch.clone, [x])


def complex(real, imag, name=None):  # noqa: A001
    return run_op("complex", torch.complex, [real, imag])


def polar(abs, angle, name=None):  # noqa: A002
    return run_op("polar", torch.polar, [abs, angle])


def clone_detached(x):
    return wrap(unwrap(x).detach())


# ---- random creation ------------------------------------------------------

def rand(shape, dtype=None, name=None):
    dev = _dev()
    return wrap(torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                           generator=_gen(dev)))


def randn(shape, dtype=None, name=None):
    dev = _dev()
    return wrap(torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                            generator=_gen(dev)))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype, name)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = unwrap(mean), unwrap(std)
        ref = m if isinstance(m, torch.Tensor) else s
        m, s = (torch.as_tensor(v, device=ref.device) for v in (m, s))
        shp = torch.broadcast_shapes(m.shape, s.shape)
        dt = m.dtype if m.is_floating_point() else torch.float32
        z = torch.randn(shp, dtype=dt, device=ref.device,
                        generator=_gen(ref.device))
        return wrap(m + s * z)
    dev = _dev()
    z = torch.randn(_shape(shape or [1]), dtype=_dt(None), device=dev,
                    generator=_gen(dev))
    return wrap(mean + std * z)


def _seeded(seed, device):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return _gen(device)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    dev = _dev()
    u = torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                   generator=_seeded(seed, dev))
    return wrap(u * (max - min) + min)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = _dev()
    return wrap(torch.randint(low, high, _shape(shape), device=dev,
                              generator=_gen(dev),
                              dtype=_dt(dtype, torch.int64)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    a = unwrap(x)
    if high is None:
        low, high = 0, low
    return wrap(torch.randint(low, high, a.shape, device=a.device,
                              generator=_gen(a.device),
                              dtype=_dt(dtype, a.dtype)))


def randperm(n, dtype="int64", name=None):
    dev = _dev()
    return wrap(torch.randperm(n, device=dev, generator=_gen(dev)).to(
        _dt(dtype, torch.int64)))


def bernoulli(x, name=None):
    a = unwrap(x)
    return wrap(torch.bernoulli(a.detach(), generator=_gen(a.device)))


def poisson(x, name=None):
    a = unwrap(x)
    return wrap(torch.poisson(a.detach(), generator=_gen(a.device)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    a = unwrap(x).detach()
    return wrap(torch.multinomial(a, num_samples, replacement,
                                  generator=_gen(a.device)).to(torch.int64))


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = _dev()
    z = torch.randn(_shape(shape), dtype=_dt(dtype, torch.float32),
                    device=dev, generator=_seeded(seed, dev))
    return wrap(mean + std * z)


def truncated_gaussian_random(shape, mean=0.0, std=1.0, seed=0, a=-2.0,
                              b=2.0, dtype=None, name=None):
    dev = _dev()
    t = torch.empty(_shape(shape), dtype=_dt(dtype, torch.float32),
                    device=dev)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, a, b,
                                generator=_seeded(seed, dev))
    return wrap(mean + std * t)


def binomial(count, prob, name=None):
    n, p = unwrap(count), unwrap(prob)
    n = torch.as_tensor(n, device=p.device).to(p.dtype)
    return wrap(torch.binomial(n, p, generator=_gen(p.device)).to(
        torch.int64))


def standard_gamma(x, name=None):
    a = unwrap(x).detach()
    return wrap(torch._standard_gamma(a, generator=_gen(a.device)))


def dirichlet(alpha, name=None):
    a = unwrap(alpha).detach()
    g = torch._standard_gamma(a, generator=_gen(a.device))
    return wrap(g / g.sum(-1, keepdim=True))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        x._data.exponential_(lam, generator=_gen(x._data.device))
    return x


def uniform_inplace(x, min=-1.0, max=1.0, seed=0, **kw):  # noqa: A002
    with torch.no_grad():
        x._data.uniform_(min, max, generator=_seeded(seed, x._data.device))
    return x


uniform_ = uniform_inplace


def gaussian_inplace(x, mean=0.0, std=1.0, seed=0, **kw):
    with torch.no_grad():
        x._data.normal_(mean, std, generator=_seeded(seed, x._data.device))
    return x


normal_ = gaussian_inplace


def full_batch_size_like(input, shape, dtype, value, input_dim_idx=0,  # noqa: A002
                         output_dim_idx=0, name=None):
    shp = list(_shape(shape))
    shp[output_dim_idx] = unwrap(input).shape[input_dim_idx]
    return full(shp, value, dtype=dtype)


def full_with_tensor(value, shape, dtype=None, name=None):
    s = unwrap(shape)
    s = s.reshape(-1).tolist() if isinstance(s, torch.Tensor) \
        else np.asarray(s).reshape(-1).tolist()
    return full([int(v) for v in s], float(_scalar(value)), dtype=dtype)


def full_int_array(value, dtype="int64", name=None):
    return wrap(torch.as_tensor(np.asarray(value), device=_dev()).to(
        _dt(dtype, torch.int64)))


def log_normal(mean=1.0, std=2.0, shape=None, dtype=None, name=None):
    out = normal(mean=mean if isinstance(mean, Tensor) else float(mean),
                 std=std if isinstance(std, Tensor) else float(std),
                 shape=list(shape) if shape is not None else [1])
    from . import manipulation, math
    out = math.exp(out)
    return manipulation.cast(out, dtype) if dtype is not None else out


def uniform_random_batch_size_like(input, shape, min=-1.0, max=1.0,  # noqa: A002
                                   input_dim_idx=0, output_dim_idx=0,
                                   dtype="float32", name=None):
    shp = [int(s) for s in shape]
    shp[output_dim_idx] = int(unwrap(input).shape[input_dim_idx])
    return uniform(shp, dtype, float(min), float(max))
