"""Audio feature layers (counterpart of ``paddle_tpu/audio/features.py``;
the reference's python/paddle/audio/features/layers.py): Spectrogram,
MelSpectrogram, LogMelSpectrogram and MFCC as ``nn.Layer``s, the window,
the filterbank and the DCT matrix held as buffers."""
from __future__ import annotations

import torch

from ..core.dispatch import run_op
from ..nn.layer.layers import Layer
from ..signal import stft
from .functional import (compute_fbank_matrix, create_dct, get_window,
                         power_to_db)

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


class Spectrogram(Layer):
    def __init__(self, n_fft: int = 512, hop_length=None, win_length=None,
                 window: str = "hann", power: float = 2.0, center=True,
                 pad_mode: str = "reflect", dtype: str = "float32"):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        self.register_buffer(
            "window", get_window(window, self.win_length, dtype=dtype))

    def forward(self, x):
        spec = stft(x, self.n_fft, self.hop_length, self.win_length,
                    window=self.window, center=self.center,
                    pad_mode=self.pad_mode)
        return run_op("spec_power",
                      lambda a: torch.abs(a) ** self.power, [spec])


class MelSpectrogram(Layer):
    def __init__(self, sr: int = 22050, n_fft: int = 512, hop_length=None,
                 win_length=None, window: str = "hann", power: float = 2.0,
                 center: bool = True, pad_mode: str = "reflect",
                 n_mels: int = 64, f_min: float = 50.0, f_max=None,
                 htk: bool = False, norm: str = "slaney",
                 dtype: str = "float32"):
        super().__init__()
        self.spectrogram = Spectrogram(n_fft, hop_length, win_length,
                                       window, power, center=center,
                                       pad_mode=pad_mode, dtype=dtype)
        self.register_buffer("fbank", compute_fbank_matrix(
            sr, n_fft, n_mels, f_min, f_max, htk, norm, dtype))

    def forward(self, x):
        spec = self.spectrogram(x)
        return run_op("mel_project",
                      lambda s, fb: torch.einsum("...ft,mf->...mt", s, fb),
                      [spec, self.fbank])


class LogMelSpectrogram(Layer):
    def __init__(self, sr: int = 22050, ref_value: float = 1.0,
                 amin: float = 1e-10, top_db=None, **kw):
        super().__init__()
        self.mel = MelSpectrogram(sr=sr, **kw)
        self.ref_value = ref_value
        self.amin = amin
        self.top_db = top_db

    def forward(self, x):
        return power_to_db(self.mel(x), self.ref_value, self.amin,
                           self.top_db)


class MFCC(Layer):
    def __init__(self, sr: int = 22050, n_mfcc: int = 40, n_mels: int = 64,
                 **kw):
        super().__init__()
        self.logmel = LogMelSpectrogram(sr=sr, n_mels=n_mels, **kw)
        self.register_buffer("dct", create_dct(n_mfcc, n_mels))

    def forward(self, x):
        lm = self.logmel(x)
        return run_op("mfcc_dct",
                      lambda a, d: torch.einsum("...mt,mc->...ct", a, d),
                      [lm, self.dct])
