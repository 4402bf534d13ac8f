"""paddle.signal (counterpart of ``paddle_tpu/signal.py``; the reference's
python/paddle/signal.py): ``stft`` and ``istft``.

The JAX package's conventions, which ``torch.stft`` does not share, are
kept: the signal is padded with ``pad_mode`` when ``center``, a window
shorter than ``n_fft`` sits centred in an ``n_fft`` buffer, the window
is cast to the signal's dtype (f32 gives complex64), the result is
[..., freq, frames], and the window takes no gradient. ``stft`` frames
the signal with ``unfold`` and takes ``rfft`` (``fft`` when not
``onesided``) of each windowed frame. ``istft`` sums the windowed
inverse frames with one ``fold`` (``ops.manipulation.overlap_add_frames``)
where the JAX package loops over frames, and divides by the window's
squares summed the same way, once."""
from __future__ import annotations


import torch
import torch.nn.functional as F

from .core.dispatch import run_op, unwrap
from .ops.manipulation import overlap_add_frames

_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "replicate": "replicate",
              "wrap": "circular", "circular": "circular"}


def _pad_last(v, pad, mode):
    """``jnp.pad`` of the last axis by ``pad`` on both sides."""
    mode = _PAD_MODES[mode]
    if mode == "constant":
        return F.pad(v, (pad, pad))
    lead = v.shape[:-1]
    out = F.pad(v.reshape(-1, 1, v.shape[-1]), (pad, pad), mode=mode)
    return out.reshape(lead + (out.shape[-1],))


def _window(win, wl, n_fft, dtype, device):
    """The window, cast to ``dtype``, centred in an ``n_fft`` buffer."""
    w = torch.zeros(n_fft, dtype=dtype, device=device)
    off = (n_fft - wl) // 2
    src = torch.ones(wl, dtype=dtype, device=device) if win is None else \
        torch.as_tensor(win).detach().to(device=device, dtype=dtype)
    w[off:off + wl] = src
    return w


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """Short-time Fourier transform: [..., T] -> [..., freq, frames]."""
    hop = hop_length or n_fft // 4
    wl = win_length or n_fft
    win = unwrap(window)

    def fn(a):
        v = a
        if center:
            v = _pad_last(v, n_fft // 2, pad_mode)
        frames = v.unfold(-1, n_fft, hop)          # [..., num, n_fft]
        w = _window(win, wl, n_fft, a.dtype, a.device)
        spec = torch.fft.rfft(frames * w, dim=-1) if onesided else \
            torch.fft.fft(frames * w, dim=-1)
        if normalized:
            spec = spec / torch.sqrt(torch.sum(w ** 2))
        return spec.transpose(-1, -2)              # [..., freq, num]
    return run_op("stft", fn, [x])


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """Inverse of ``stft``: [..., freq, frames] -> [..., T]."""
    hop = hop_length or n_fft // 4
    wl = win_length or n_fft
    win = unwrap(window)

    def fn(a):
        spec = a.transpose(-1, -2)                 # [..., num, freq]
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1) if onesided else \
            torch.fft.ifft(spec, dim=-1).real
        w = _window(win, wl, n_fft, frames.dtype, frames.device)
        if normalized:
            frames = frames * torch.sqrt(torch.sum(w ** 2))
        frames = frames * w
        num = frames.shape[-2]
        out = overlap_add_frames(frames.transpose(-1, -2), hop)
        norm = overlap_add_frames((w ** 2)[:, None].expand(n_fft, num), hop)
        out = out / torch.clamp_min(norm, 1e-11)
        out_len = out.shape[-1]
        if center:
            pad = n_fft // 2
            out = out[..., pad:out_len - pad]
        if length is not None:
            out = out[..., :length]
        return out
    return run_op("istft", fn, [x])


__all__ = ["stft", "istft"]
