"""Pooling functionals (counterpart of ``paddle_tpu/nn/functional/pooling.py``).

The JAX package reduces windows with ``lax.reduce_window`` over an input
padded with the reduction's identity; the port pads the same way with
``F.pad`` (-inf for max, 0 for sums) and runs torch's pooling with no
padding of its own (cuDNN on the card), so every window is the JAX one:

- ``ceil_mode`` grows the high pad until the last window fits
  (``_ceil_extra``); the grown pad counts as padding everywhere;
- average pooling divides by the window size, or with ``exclusive`` (the
  default; torch's ``count_include_pad=False``) by the number of real
  elements in the window, ceil-mode pads excluded; a "SAME" / "VALID"
  string padding always divides by the window size, as in JAX;
- ``return_mask`` gives each max's flat index into the unpadded spatial
  dims, from windows without the ceil-mode growth (as the JAX mask is);
- adaptive pooling takes the JAX segments [floor(i n / o), ceil((i + 1)
  n / o)), which are torch's; the adaptive max's mask is the JAX
  placeholder, one int64 zero;
- ``lp_pool`` is the p-th root of the window sum of |x|^p;
- ``max_unpool`` scatters the values to their mask indices;
- fractional max pooling places its windows by the JAX package's
  ``_fractional_edges`` (torch's fractional pooling places them
  differently), with ``random_u`` drawn from numpy's global generator
  when not given, as in JAX.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import run_op_nodiff, surface
from .conv import (_flat_pad, _padding, _same_pads, _to_first, _to_last,
                   _tuple)

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_AMAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
         3: TF.adaptive_max_pool3d}
_AAVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
         3: TF.adaptive_avg_pool3d}


def _ceil_extra(pairs, sp_shape, ksize, strides):
    """ceil_mode: grow the high pad so the last window fits."""
    out = list(pairs)
    for i in range(len(ksize)):
        lo, hi = out[i]
        rem = (sp_shape[i] + lo + hi - ksize[i]) % strides[i]
        if rem:
            out[i] = (lo, hi + (strides[i] - rem))
    return out


def _pairs(pad, sp, ksize, strides, ceil_mode):
    """(lo, hi) pairs of a channels-first input, and whether the padding
    was a string."""
    nd = len(ksize)
    if pad == "SAME":
        return _same_pads(sp, ksize, strides, (1,) * nd), True
    if pad == "VALID":
        return [(0, 0)] * nd, True
    return (_ceil_extra(pad, sp, ksize, strides) if ceil_mode
            else list(pad)), False


def _padded(a, pairs, value):
    if any(lo or hi for lo, hi in pairs):
        return TF.pad(a, _flat_pad(pairs), value=value)
    return a


def _pool_body(a, nd, ksize, strides, pad, kind, ceil_mode=False,
               exclusive=True):
    """Channels-first pooling: kind "max", "avg" or "sum"."""
    pairs, is_str = _pairs(pad, a.shape[2:], ksize, strides, ceil_mode)
    if kind == "max":
        return _MAX[nd](_padded(a, pairs, float("-inf")), ksize, strides)
    out = _AVG[nd](_padded(a, pairs, 0.0), ksize, strides)
    if kind == "sum":
        return out * float(np.prod(ksize))
    if exclusive and not is_str:
        ones = torch.ones((1, 1) + tuple(a.shape[2:]), dtype=a.dtype,
                          device=a.device)
        out = out / _AVG[nd](_padded(ones, pairs, 0.0), ksize, strides)
    return out


def _pool(name, x, nd, kernel_size, stride, padding, channel_last, kind,
          ceil_mode=False, exclusive=True):
    ksize = _tuple(kernel_size, nd)
    strides = _tuple(stride if stride is not None else kernel_size, nd)
    pad = _padding(padding, nd)

    def fn(a):
        out = _pool_body(_to_first(a, channel_last), nd, ksize, strides,
                         pad, kind, ceil_mode, exclusive)
        return _to_last(out, channel_last).to(a.dtype)
    return surface(name, fn, [x])


def _pool_mask(x, nd, kernel_size, stride, padding, channel_last):
    """Each max's flat index into the unpadded spatial dims (-1 for a
    window of padding only), from the windows without ceil-mode growth."""
    ksize = _tuple(kernel_size, nd)
    strides = _tuple(stride if stride is not None else kernel_size, nd)
    pad = _padding(padding, nd)

    def fn(a):
        a = _to_first(a, channel_last)
        sp = a.shape[2:]
        pairs, _ = _pairs(pad, sp, ksize, strides, False)
        ap = _padded(a, pairs, float("-inf"))
        _, idx = _MAX[nd](ap, ksize, strides, return_indices=True)
        sp_p = ap.shape[2:]
        flat = torch.zeros_like(idx)
        ok = torch.ones_like(idx, dtype=torch.bool)
        rest, mult = idx, 1
        for d in reversed(range(nd)):      # padded coords -> unpadded flat
            c = rest % sp_p[d] - pairs[d][0]
            rest = rest // sp_p[d]
            ok &= (c >= 0) & (c < sp[d])
            flat = flat + c * mult
            mult *= sp[d]
        flat = torch.where(ok, flat, torch.full_like(flat, -1))
        return _to_last(flat, channel_last).to(torch.int64)
    return run_op_nodiff("max_pool_mask", fn, [x])


def _max_pool(name, x, nd, kernel_size, stride, padding, return_mask,
              ceil_mode, channel_last):
    out = _pool(name, x, nd, kernel_size, stride, padding, channel_last,
                "max", ceil_mode=ceil_mode)
    if return_mask:
        return out, _pool_mask(x, nd, kernel_size, stride, padding,
                               channel_last)
    return out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool("max_pool1d", x, 1, kernel_size, stride, padding,
                     return_mask, ceil_mode, data_format == "NLC")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool("max_pool2d", x, 2, kernel_size, stride, padding,
                     return_mask, ceil_mode, data_format == "NHWC")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool("max_pool3d", x, 3, kernel_size, stride, padding,
                     return_mask, ceil_mode, data_format == "NDHWC")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool("avg_pool1d", x, 1, kernel_size, stride, padding,
                 data_format == "NLC", "avg", ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    if divisor_override:
        out = _pool("avg_pool2d", x, 2, kernel_size, stride, padding,
                    data_format == "NHWC", "sum", ceil_mode)
        return out * (1.0 / divisor_override)
    return _pool("avg_pool2d", x, 2, kernel_size, stride, padding,
                 data_format == "NHWC", "avg", ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool("avg_pool3d", x, 3, kernel_size, stride, padding,
                 data_format == "NDHWC", "avg", ceil_mode, exclusive)


def _lp_pool(name, x, nd, norm_type, kernel_size, stride, padding,
             ceil_mode, channel_last):
    p = float(norm_type)
    ksize = _tuple(kernel_size, nd)
    strides = _tuple(stride if stride is not None else kernel_size, nd)
    pad = _padding(padding, nd)

    def fn(a):
        s = _pool_body(_to_first(torch.abs(a) ** p, channel_last), nd,
                       ksize, strides, pad, "sum", ceil_mode)
        return _to_last(s, channel_last).to(a.dtype) ** (1.0 / p)
    return surface(name, fn, [x])


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _lp_pool("lp_pool1d", x, 1, norm_type, kernel_size, stride,
                    padding, ceil_mode, data_format == "NLC")


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool("lp_pool2d", x, 2, norm_type, kernel_size, stride,
                    padding, ceil_mode, data_format == "NHWC")


def _adaptive_pool(name, x, output_size, nd, channel_last, is_max,
                   return_mask=False):
    osize = _tuple(output_size, nd)
    op = _AMAX[nd] if is_max else _AAVG[nd]

    def fn(a):
        return _to_last(op(_to_first(a, channel_last), osize), channel_last)
    out = surface(name, fn, [x])
    if return_mask:
        mask = run_op_nodiff(name + "_mask", lambda a: torch.zeros(
            [1], dtype=torch.int64, device=a.device), [x])
        return out, mask
    return out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool("adaptive_avg_pool1d", x, output_size, 1, False,
                          False)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool("adaptive_avg_pool2d", x, output_size, 2,
                          data_format == "NHWC", False)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool("adaptive_avg_pool3d", x, output_size, 3,
                          data_format == "NDHWC", False)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool("adaptive_max_pool1d", x, output_size, 1, False,
                          True, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool("adaptive_max_pool2d", x, output_size, 2, False,
                          True, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool("adaptive_max_pool3d", x, output_size, 3, False,
                          True, return_mask)


def _max_unpool(name, x, indices, nd, kernel_size, stride, padding,
                data_format, output_size):
    ksize = _tuple(kernel_size, nd)
    strides = _tuple(stride if stride is not None else kernel_size, nd)
    pads = _tuple(padding, nd)
    channel_last = data_format in ("NLC", "NHWC", "NDHWC")

    def fn(a, idx):
        a, idx = _to_first(a, channel_last), _to_first(idx, channel_last)
        sp_in = a.shape[2:]
        if output_size is not None:
            sp_out = tuple(int(s) for s in output_size)[-nd:]
        else:
            sp_out = tuple((sp_in[d] - 1) * strides[d] - 2 * pads[d]
                           + ksize[d] for d in range(nd))
        n, c = a.shape[0], a.shape[1]
        out = torch.zeros((n, c, int(np.prod(sp_out))), dtype=a.dtype,
                          device=a.device)
        out = out.scatter(2, idx.reshape(n, c, -1).to(torch.int64),
                          a.reshape(n, c, -1))
        return _to_last(out.reshape((n, c) + sp_out), channel_last)
    return surface(name, fn, [x, indices])


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    """The inverse of max_pool1d with its return_mask indices."""
    return _max_unpool("max_unpool1d", x, indices, 1, kernel_size, stride,
                       padding, data_format, output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool("max_unpool2d", x, indices, 2, kernel_size, stride,
                       padding, data_format, output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool("max_unpool3d", x, indices, 3, kernel_size, stride,
                       padding, data_format, output_size)


def _fractional_edges(in_size, out_size, u):
    """Graham's pseudo-random boundaries b_i = ceil(a (i + u)), a = in /
    out, shifted to start at 0 and end at in_size."""
    alpha = in_size / out_size
    base = int(np.ceil(alpha * u)) if u > 0 else 0
    edges = []
    for i in range(out_size + 1):
        e = int(np.ceil(alpha * (i + u))) - base
        edges.append(min(max(e, i), in_size))
    edges[0], edges[-1] = 0, in_size
    return edges


def _fractional_pool(name, x, output_size, nd, kernel_size, random_u,
                     return_mask):
    out_sp = _tuple(output_size, nd)
    ks = _tuple(kernel_size, nd) if kernel_size is not None else None
    u = float(np.random.uniform(0.01, 0.99)) if random_u is None \
        else float(random_u)

    def windows(sp_in):
        wins = []
        for d in range(nd):
            edges = _fractional_edges(sp_in[d], out_sp[d], u)
            row = []
            for i in range(out_sp[d]):
                s = edges[i]
                e = s + ks[d] if ks is not None else edges[i + 1]
                row.append((s, min(max(e, s + 1), sp_in[d])))
            wins.append(row)
        return wins

    def fn(a):
        sp_in = a.shape[2:2 + nd]
        wins = windows(sp_in)
        # the max over a box is the max over its axes in turn
        out = a
        for d in range(nd):
            out = torch.stack([out[(slice(None),) * (2 + d)
                                   + (slice(s, e),)].amax(dim=2 + d)
                               for s, e in wins[d]], dim=2 + d)
        if not return_mask:
            return out
        flat_sp = torch.arange(int(np.prod(sp_in)), device=a.device
                               ).reshape(sp_in)
        idxs = []
        for pos in itertools.product(*[range(o) for o in out_sp]):
            sl = tuple(slice(*wins[d][pos[d]]) for d in range(nd))
            window = a[(slice(None), slice(None)) + sl]
            am = window.reshape(window.shape[:2] + (-1,)).argmax(dim=-1)
            idxs.append(flat_sp[sl].reshape(-1)[am])
        mask = torch.stack(idxs, dim=-1).reshape(a.shape[:2] + out_sp)
        return out, mask.to(torch.int64)
    return surface(name, fn, [x])


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """Fractional max pooling (Graham 2014); disjoint windows when
    kernel_size is None."""
    return _fractional_pool("fractional_max_pool2d", x, output_size, 2,
                            kernel_size, random_u, return_mask)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_pool("fractional_max_pool3d", x, output_size, 3,
                            kernel_size, random_u, return_mask)
