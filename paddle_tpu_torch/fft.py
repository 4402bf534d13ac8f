"""paddle.fft (counterpart of ``paddle_tpu/fft.py``; the reference's
python/paddle/fft.py and the fft_c2c / fft_r2c / fft_c2r kernels of
ops.yaml) on ``torch.fft``, which runs cuFFT on the card.

Every transform is a differentiable ``run_op`` under the JAX package's
op name; ``norm`` is "backward" unless "ortho" or "forward" is given, as
in JAX. A float32 input gives complex64, float64 complex128. The
Hermitian n-d transforms compose c2c transforms over the leading axes
with a 1-d ``hfft`` / ``ihfft`` over the last, as the JAX package does
(``_h_axes`` picks the axes by numpy's rule).

On the CPU an n-d transform runs as 1-d transforms, one axis after the
other (the same separable passes): torch's CPU multi-axis transforms over
a leading axis corrupt the heap at some shapes (``fftn`` over dims (0, 1)
of a [2, 3001, 201] complex64 tensor aborts the process, torch 2.11 and
2.13). On the card they are cuFFT's n-d plans."""
from __future__ import annotations

import torch

from .core import place as place_mod
from .core.dispatch import run_op, wrap


def _norm(norm):
    return norm if norm in ("ortho", "forward") else "backward"


def _op1(op_name, fn):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        return run_op(op_name, lambda a: fn(a, n=n, dim=axis,
                                            norm=_norm(norm)), [x])
    op.__name__ = op_name
    return op


fft = _op1("fft", torch.fft.fft)
ifft = _op1("ifft", torch.fft.ifft)
rfft = _op1("rfft", torch.fft.rfft)
irfft = _op1("irfft", torch.fft.irfft)
hfft = _op1("hfft", torch.fft.hfft)
ihfft = _op1("ihfft", torch.fft.ihfft)


def _axes(a, s, dim):
    """(dims, sizes) of an n-d transform by torch's / numpy's rule."""
    if dim is None:
        dims = tuple(range(a.dim() - len(s), a.dim())) if s is not None \
            else tuple(range(a.dim()))
    else:
        dims = tuple(int(d) % a.dim() for d in (
            (dim,) if isinstance(dim, int) else dim))
    sizes = tuple(s) if s is not None else (None,) * len(dims)
    return dims, sizes


def _c2c(a, s, dim, norm, inverse):
    if a.device.type != "cpu":
        return (torch.fft.ifftn if inverse else torch.fft.fftn)(
            a, s=s, dim=dim, norm=norm)
    f = torch.fft.ifft if inverse else torch.fft.fft
    for d, n in zip(*_axes(a, s, dim)):
        a = f(a, n=n, dim=d, norm=norm)
    return a


def _r2c(a, s, dim, norm):
    if a.device.type != "cpu":
        return torch.fft.rfftn(a, s=s, dim=dim, norm=norm)
    dims, sizes = _axes(a, s, dim)
    a = torch.fft.rfft(a, n=sizes[-1], dim=dims[-1], norm=norm)
    for d, n in zip(dims[:-1], sizes[:-1]):
        a = torch.fft.fft(a, n=n, dim=d, norm=norm)
    return a


def _c2r(a, s, dim, norm):
    if a.device.type != "cpu":
        return torch.fft.irfftn(a, s=s, dim=dim, norm=norm)
    dims, sizes = _axes(a, s, dim)
    for d, n in zip(dims[:-1], sizes[:-1]):
        a = torch.fft.ifft(a, n=n, dim=d, norm=norm)
    return torch.fft.irfft(a, n=sizes[-1], dim=dims[-1], norm=norm)


def _fftn(a, s=None, dim=None, norm=None):
    return _c2c(a, s, dim, norm, False)


def _ifftn(a, s=None, dim=None, norm=None):
    return _c2c(a, s, dim, norm, True)


def _opn(op_name, fn):
    def op(x, s=None, axes=None, norm="backward", name=None):
        ax = tuple(axes) if axes is not None else None
        sz = tuple(s) if s is not None else None
        return run_op(op_name, lambda a: fn(a, s=sz, dim=ax,
                                            norm=_norm(norm)), [x])
    op.__name__ = op_name
    return op


fftn = _opn("fftn", _fftn)
ifftn = _opn("ifftn", _ifftn)
rfftn = _opn("rfftn", _r2c)
irfftn = _opn("irfftn", _c2r)


def fft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return fftn(x, s=s, axes=axes, norm=norm)


def ifft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return ifftn(x, s=s, axes=axes, norm=norm)


def rfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return rfftn(x, s=s, axes=axes, norm=norm)


def irfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return irfftn(x, s=s, axes=axes, norm=norm)


def fftfreq(n, d=1.0, dtype=None, name=None):
    """Sample frequencies, float64 as ``jnp.fft.fftfreq`` returns them
    (``dtype`` is ignored, as in the JAX package), on the current
    place."""
    return wrap(torch.fft.fftfreq(n, d, dtype=torch.float64,
                                  device=place_mod.current_device()))


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return wrap(torch.fft.rfftfreq(n, d, dtype=torch.float64,
                                   device=place_mod.current_device()))


def fftshift(x, axes=None, name=None):
    return run_op("fftshift", lambda a: torch.fft.fftshift(a, dim=axes),
                  [x])


def ifftshift(x, axes=None, name=None):
    return run_op("ifftshift", lambda a: torch.fft.ifftshift(a, dim=axes),
                  [x])


# the reference's kernel-level names (ops.yaml: fft_c2c / fft_r2c / fft_c2r)
def fft_c2c(x, axes, normalization="backward", forward=True, name=None):
    return run_op("fft_c2c", lambda a: _c2c(
        a, None, tuple(axes), _norm(normalization), not forward), [x])


def fft_r2c(x, axes, normalization="backward", forward=True, onesided=True,
            name=None):
    return run_op("fft_r2c", lambda a: _r2c(a, None, tuple(axes),
                                            _norm(normalization)), [x])


def fft_c2r(x, axes, normalization="backward", forward=True, last_dim_size=0,
            name=None):
    def fn(a):
        s = None
        if last_dim_size:
            s = [a.shape[ax] for ax in axes]
            s[-1] = int(last_dim_size)
        return _c2r(a, s, tuple(axes), _norm(normalization))
    return run_op("fft_c2r", fn, [x])


def _h_axes(a_ndim, s, axes, two_d):
    if axes is None:
        if two_d:
            axes = (-2, -1)
        elif s is not None:
            # numpy semantics: s given -> transform the last len(s) dims
            axes = tuple(range(a_ndim - len(s), a_ndim))
        else:
            axes = tuple(range(a_ndim))
    axes = tuple(int(ax) for ax in axes)
    if s is not None:
        s = tuple(int(v) for v in s)
    return s, axes


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    """N-d FFT of a Hermitian-symmetric input -> a real output: c2c FFTs
    over the leading axes, then a 1-d hfft (c2r) over the last."""
    def fn(a):
        ss, axs = _h_axes(a.dim(), s, axes, two_d=False)
        lead, last = axs[:-1], axs[-1]
        if lead:
            a = _fftn(a, s=None if ss is None else ss[:-1], dim=lead,
                      norm=_norm(norm))
        n_last = None if ss is None else ss[-1]
        return torch.fft.hfft(a, n=n_last, dim=last, norm=_norm(norm))
    return run_op("hfftn", fn, [x])


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """2-d Hermitian FFT."""
    def fn(a):
        ss, axs = _h_axes(a.dim(), s, axes, two_d=True)
        a2 = torch.fft.fft(a, n=None if ss is None else ss[0], dim=axs[0],
                           norm=_norm(norm))
        return torch.fft.hfft(a2, n=None if ss is None else ss[1],
                              dim=axs[1], norm=_norm(norm))
    return run_op("hfft2", fn, [x])


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    """Inverse of hfftn: a real input -> its Hermitian half-spectrum."""
    def fn(a):
        ss, axs = _h_axes(a.dim(), s, axes, two_d=False)
        lead, last = axs[:-1], axs[-1]
        out = torch.fft.ihfft(a, n=None if ss is None else ss[-1], dim=last,
                              norm=_norm(norm))
        if lead:
            out = _ifftn(out, s=None if ss is None else ss[:-1], dim=lead,
                         norm=_norm(norm))
        return out
    return run_op("ihfftn", fn, [x])


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """2-d inverse Hermitian FFT."""
    def fn(a):
        ss, axs = _h_axes(a.dim(), s, axes, two_d=True)
        out = torch.fft.ihfft(a, n=None if ss is None else ss[1],
                              dim=axs[1], norm=_norm(norm))
        return torch.fft.ifft(out, n=None if ss is None else ss[0],
                              dim=axs[0], norm=_norm(norm))
    return run_op("ihfft2", fn, [x])


__all__ = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fftn",
           "ifftn", "rfftn", "irfftn", "fft2", "ifft2", "rfft2", "irfft2",
           "hfftn", "hfft2", "ihfftn", "ihfft2", "fftfreq", "rfftfreq",
           "fftshift", "ifftshift", "fft_c2c", "fft_r2c", "fft_c2r"]
