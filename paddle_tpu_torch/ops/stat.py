"""Statistics ops (counterpart of ``paddle_tpu/ops/stat.py``)."""
from __future__ import annotations

import torch

from ..core.dispatch import run_op, run_op_nodiff, unwrap
from .math import _dims, _float_of


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return run_op("var", lambda a: torch.var(
        _float_of(a), dim=_dims(a, axis), correction=int(unbiased),
        keepdim=keepdim), [x])


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return run_op("std", lambda a: torch.std(
        _float_of(a), dim=_dims(a, axis), correction=int(unbiased),
        keepdim=keepdim), [x])


def _median_along(a, ax, keepdim, mode, nan):
    """numpy's median (mean of the two middle values) for ``avg``; the
    lower middle value for ``min``."""
    n = a.shape[ax]
    srt = torch.sort(a, dim=ax).values
    if nan:
        cnt = (~torch.isnan(a)).sum(dim=ax, keepdim=True)
    else:
        cnt = torch.full_like(srt.narrow(ax, 0, 1), n, dtype=torch.int64)
    lo = torch.clamp((cnt - 1) // 2, min=0)
    hi = torch.clamp(cnt // 2, min=0) if mode == "avg" else lo
    out = (torch.take_along_dim(srt, lo, dim=ax)
           + torch.take_along_dim(srt, hi, dim=ax)) / 2
    return out if keepdim else out.squeeze(ax)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    def fn(a):
        a = _float_of(a)
        if axis is None:
            out = _median_along(a.reshape(-1), 0, False, mode, False)
            return out.reshape([1] * a.dim()) if keepdim else out
        return _median_along(a, axis, keepdim, mode, False)
    return run_op("median", fn, [x])


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    def fn(a):
        a = _float_of(a)
        if axis is None:
            out = _median_along(a.reshape(-1), 0, False, mode, True)
            return out.reshape([1] * a.dim()) if keepdim else out
        return _median_along(a, axis, keepdim, mode, True)
    return run_op("nanmedian", fn, [x])


def _quantile(fn, x, q, axis, keepdim, interpolation):
    qv = unwrap(q)

    def body(a):
        qt = torch.as_tensor(qv, dtype=a.dtype, device=a.device)
        if axis is None:
            out = fn(a.reshape(-1), qt, dim=0, interpolation=interpolation)
            if keepdim:
                out = out.reshape(out.shape + (1,) * a.dim())
            return out
        return fn(a, qt, dim=axis, keepdim=keepdim,
                  interpolation=interpolation)
    return body


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return run_op("quantile", _quantile(torch.quantile, x, q, axis, keepdim,
                                        interpolation), [x])


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return run_op("nanquantile", _quantile(torch.nanquantile, x, q, axis,
                                           keepdim, interpolation), [x])


def corrcoef(x, rowvar=True, name=None):
    return run_op("corrcoef", lambda a: torch.corrcoef(a if rowvar
                                                       else a.T), [x])


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return run_op("cov", lambda a: torch.cov(
        a if rowvar else a.T, correction=int(ddof),
        fweights=unwrap(fweights), aweights=unwrap(aweights)), [x])


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    def fn(x, y):
        topk = torch.argsort(-x, dim=-1)[..., :k]
        hit = torch.any(topk == y.reshape(-1, 1), dim=-1)
        return torch.mean(hit.float())
    return run_op_nodiff("accuracy", fn, [input, label])


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,  # noqa: A002
        slide_steps=1, name=None):
    def fn(x, y):
        pos_prob = x[:, 1] if x.dim() == 2 else x
        bins = torch.clamp((pos_prob * num_thresholds).to(torch.int64), 0,
                           num_thresholds)
        yb = y.reshape(-1).bool()
        # float64, as the JAX package's (its default float with x64 on)
        z = torch.zeros(num_thresholds + 1, dtype=torch.float64,
                        device=x.device)
        pos_hist = z.index_add(0, bins, yb.double())
        neg_hist = z.index_add(0, bins, (~yb).double())
        tp = torch.cumsum(pos_hist.flip(0), 0)
        fp = torch.cumsum(neg_hist.flip(0), 0)
        zero = torch.zeros(1, dtype=torch.float64, device=x.device)
        tpr = torch.cat([zero, tp]) / torch.clamp(tp[-1], min=1e-6)
        fpr = torch.cat([zero, fp]) / torch.clamp(fp[-1], min=1e-6)
        return torch.trapezoid(tpr, fpr)
    return run_op_nodiff("auc", fn, [input, label])


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    def fn(a):
        lo, hi = (float(min), float(max)) if (min != 0 or max != 0) else (
            float(a.min()), float(a.max()))
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        return torch.linspace(lo, hi, int(bins) + 1, dtype=_float_of(a).dtype,
                              device=a.device)
    return run_op_nodiff("histogram_bin_edges", fn, [input])
