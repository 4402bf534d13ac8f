"""Audio functional ops (counterpart of ``paddle_tpu/audio/functional.py``;
the reference's python/paddle/audio/functional): windows, mel frequency
helpers, the mel filterbank, the DCT matrix and ``power_to_db``.

The windows, the filterbank and the DCT are built in float64 numpy and
cast to ``dtype`` on the current place, as the JAX package builds them;
``hz_to_mel`` / ``mel_to_hz`` return a Python float for a scalar and a
float64 tensor otherwise."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ..core.dispatch import run_op, unwrap, wrap

__all__ = ["get_window", "hz_to_mel", "mel_to_hz", "mel_frequencies",
           "fft_frequencies", "compute_fbank_matrix", "power_to_db",
           "create_dct"]


def _host(a):
    a = unwrap(a)
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return a


def _tensor(a, dtype):
    return wrap(torch.as_tensor(
        np.asarray(a), device=place_mod.current_device()).to(
            dtype_mod.dtype(dtype).torch_dtype))


def get_window(window: str, win_length: int, fftbins: bool = True,
               dtype: str = "float32"):
    """hann / hamming / blackman / bartlett / rect windows."""
    n = win_length
    m = n if not fftbins else n + 1
    if n < 2:  # a 1-sample window (scipy returns [1.0])
        return _tensor(np.ones(n), dtype)
    k = np.arange(m)
    if window in ("hann", "hanning"):
        w = 0.5 - 0.5 * np.cos(2 * np.pi * k / (m - 1))
    elif window == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * k / (m - 1))
    elif window == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * k / (m - 1))
             + 0.08 * np.cos(4 * np.pi * k / (m - 1)))
    elif window == "bartlett":
        w = 1.0 - np.abs(2 * k / (m - 1) - 1)
    elif window in ("rect", "boxcar", "ones"):
        w = np.ones(m)
    else:
        raise ValueError(f"unknown window {window!r}")
    w = w[:n] if fftbins else w
    return _tensor(w, dtype)


def hz_to_mel(freq, htk: bool = False):
    f = np.asarray(_host(freq), np.float64)
    if htk:
        out = 2595.0 * np.log10(1.0 + f / 700.0)
    else:
        f_min, f_sp = 0.0, 200.0 / 3
        out = (f - f_min) / f_sp
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = math.log(6.4) / 27.0
        out = np.where(f >= min_log_hz,
                       min_log_mel + np.log(np.maximum(f, 1e-10)
                                            / min_log_hz) / logstep, out)
    return float(out) if out.ndim == 0 else _tensor(out, "float64")


def mel_to_hz(mel, htk: bool = False):
    m = np.asarray(_host(mel), np.float64)
    if htk:
        out = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    else:
        f_min, f_sp = 0.0, 200.0 / 3
        out = f_min + f_sp * m
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = math.log(6.4) / 27.0
        out = np.where(m >= min_log_mel,
                       min_log_hz * np.exp(logstep * (m - min_log_mel)),
                       out)
    return float(out) if out.ndim == 0 else _tensor(out, "float64")


def compute_fbank_matrix(sr: int, n_fft: int, n_mels: int = 64,
                         f_min: float = 0.0, f_max=None, htk: bool = False,
                         norm: str = "slaney", dtype: str = "float32"):
    """The mel filterbank [n_mels, n_fft // 2 + 1]."""
    f_max = f_max or sr / 2
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk),
                          n_mels + 2)
    hz_pts = _host(mel_to_hz(mel_pts, htk))
    fb = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        lo, ce, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (freqs - lo) / max(ce - lo, 1e-10)
        down = (hi - freqs) / max(hi - ce, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb *= enorm[:, None]
    return _tensor(fb, dtype)


def create_dct(n_mfcc: int, n_mels: int, norm="ortho",
               dtype: str = "float32"):
    """The DCT-II matrix [n_mels, n_mfcc]."""
    k = np.arange(n_mels)
    dct = np.cos(np.pi / n_mels * (k[:, None] + 0.5)
                 * np.arange(n_mfcc)[None, :])
    if norm == "ortho":
        dct[:, 0] *= 1.0 / math.sqrt(2)
        dct *= math.sqrt(2.0 / n_mels)
    else:
        dct *= 2.0
    return _tensor(dct, dtype)


def power_to_db(magnitude, ref_value: float = 1.0, amin: float = 1e-10,
                top_db=80.0):
    """10 log10(max(x, amin) / max(ref, amin)), floored at the maximum
    over the whole input less ``top_db`` when ``top_db`` is given."""
    ref_db = 10.0 * math.log10(max(ref_value, amin))

    def fn(a):
        db = 10.0 * torch.log10(torch.clamp_min(a, amin)) - ref_db
        if top_db is not None:
            db = torch.maximum(db, db.amax() - top_db)
        return db
    return run_op("power_to_db", fn, [magnitude])


def fft_frequencies(sr: int, n_fft: int, dtype="float32"):
    """The centre frequencies of the FFT bins."""
    return _tensor(np.linspace(0, float(sr) / 2, 1 + n_fft // 2), dtype)


def mel_frequencies(n_mels: int = 64, f_min: float = 0.0,
                    f_max: float = 11025.0, htk: bool = False,
                    dtype="float32"):
    """A mel-spaced frequency grid, in Hz."""
    mels = np.linspace(hz_to_mel(f_min, htk=htk), hz_to_mel(f_max, htk=htk),
                       n_mels)
    return _tensor(_host(mel_to_hz(mels, htk=htk)), dtype)
