"""Audio IO backends (counterpart of ``paddle_tpu/audio/backends.py``;
the reference's python/paddle/audio/backends: wave_backend and the
backend registry). The backend reads and writes 16-bit PCM WAV through
the stdlib ``wave`` module, as the reference's wave_backend does; a
loaded waveform is a float32 tensor on the current place.
"""
from __future__ import annotations

import wave as _wave

import numpy as np

__all__ = ["list_available_backends", "get_current_backend",
           "set_backend", "AudioInfo", "info", "load", "save"]

_current = "wave_backend"


def list_available_backends():
    """(reference: backends.list_available_backends — paddleaudio adds
    'soundfile'; only the in-tree wave backend ships here)."""
    return ["wave_backend"]


def get_current_backend():
    return _current


def set_backend(backend_name):
    if backend_name not in list_available_backends():
        raise NotImplementedError(
            f"backend {backend_name} is not available; install "
            "paddleaudio for soundfile support")
    global _current
    _current = backend_name


class AudioInfo:
    """(reference: backends/backend.py AudioInfo)"""

    def __init__(self, sample_rate, num_samples, num_channels,
                 bits_per_sample, encoding):
        self.sample_rate = sample_rate
        self.num_samples = num_samples
        self.num_channels = num_channels
        self.bits_per_sample = bits_per_sample
        self.encoding = encoding


def info(filepath):
    """WAV header info (reference: audio.info)."""
    with _wave.open(str(filepath), "rb") as f:
        return AudioInfo(f.getframerate(), f.getnframes(),
                         f.getnchannels(), f.getsampwidth() * 8,
                         "PCM_S")


def load(filepath, frame_offset=0, num_frames=-1, normalize=True,
         channels_first=True):
    """Load a 16-bit PCM WAV into a float32 Tensor (reference:
    audio.load). Returns (waveform [C, T] or [T, C], sample_rate)."""
    from ..core.tensor import to_tensor
    with _wave.open(str(filepath), "rb") as f:
        sr = f.getframerate()
        nch = f.getnchannels()
        width = f.getsampwidth()
        f.setpos(frame_offset)
        n = f.getnframes() - frame_offset if num_frames < 0 else num_frames
        raw = f.readframes(n)
    if width != 2:
        raise NotImplementedError("only 16-bit PCM WAV is supported")
    data = np.frombuffer(raw, np.int16).reshape(-1, nch)
    wavef = data.astype(np.float32) / 32768.0 if normalize \
        else data.astype(np.float32)
    if channels_first:
        wavef = wavef.T
    return to_tensor(np.ascontiguousarray(wavef)), sr


def save(filepath, src, sample_rate, channels_first=True,
         encoding="PCM_S", bits_per_sample=16):
    """Save a float32 Tensor to 16-bit PCM WAV (reference: audio.save)."""
    from ..core.tensor import Tensor, to_numpy
    if bits_per_sample != 16:
        raise NotImplementedError("only 16-bit PCM WAV is supported")
    if isinstance(src, Tensor):
        src = src._data
    a = to_numpy(src) if hasattr(src, "detach") else np.asarray(src)
    if channels_first:
        a = a.T  # -> [T, C]
    pcm = np.clip(a * 32768.0, -32768, 32767).astype(np.int16)
    with _wave.open(str(filepath), "wb") as f:
        f.setnchannels(pcm.shape[1] if pcm.ndim > 1 else 1)
        f.setsampwidth(2)
        f.setframerate(int(sample_rate))
        f.writeframes(pcm.tobytes())
