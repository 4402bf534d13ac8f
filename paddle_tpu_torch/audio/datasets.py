"""Audio datasets (counterpart of ``paddle_tpu/audio/datasets.py``; the
reference's python/paddle/audio/datasets: TESS, ESC50). The waveforms
are synthetic and seeded (class-conditional tones plus noise, the
reference's label structure), bit-equal to the JAX package's; the
features are computed with the port's feature layers on the current
place and returned as numpy."""
from __future__ import annotations

import numpy as np

from ..io import Dataset

__all__ = ["TESS", "ESC50"]


class _SyntheticAudio(Dataset):
    def __init__(self, n_classes, num_samples, sr, duration, seed,
                 feat_type="raw", **feat_kwargs):
        rng = np.random.default_rng(seed)
        t = np.arange(int(sr * duration)) / sr
        self._labels = rng.integers(0, n_classes, num_samples)
        waves = []
        for lab in self._labels:
            f0 = 120.0 * (1 + lab)
            tone = 0.6 * np.sin(2 * np.pi * f0 * t) \
                + 0.2 * np.sin(2 * np.pi * 2 * f0 * t)
            waves.append(tone + 0.1 * rng.standard_normal(len(t)))
        self._waves = np.stack(waves).astype(np.float32)
        self.sample_rate = sr
        self.feat_type = feat_type
        self.feat_kwargs = feat_kwargs

    def __len__(self):
        return len(self._labels)

    def _features(self, wave):
        if self.feat_type == "raw":
            return wave
        from . import features as F
        from ..core.tensor import to_tensor
        x = to_tensor(wave[None])
        if self.feat_type == "mfcc":
            out = F.MFCC(sr=self.sample_rate, **self.feat_kwargs)(x)
        elif self.feat_type == "spectrogram":
            out = F.Spectrogram(**self.feat_kwargs)(x)
        elif self.feat_type == "melspectrogram":
            out = F.MelSpectrogram(sr=self.sample_rate,
                                   **self.feat_kwargs)(x)
        elif self.feat_type == "logmelspectrogram":
            out = F.LogMelSpectrogram(sr=self.sample_rate,
                                      **self.feat_kwargs)(x)
        else:
            raise ValueError(f"unknown feat_type {self.feat_type}")
        return out.numpy()[0]

    def __getitem__(self, idx):
        return self._features(self._waves[idx]), self._labels[idx]


class TESS(_SyntheticAudio):
    """Toronto emotional speech set shape: 7 emotion classes (reference:
    audio/datasets/tess.py)."""

    def __init__(self, mode="train", n_folds=5, split=1, feat_type="raw",
                 archive=None, num_samples=200, **kwargs):
        seed = 7 if mode == "train" else 8
        super().__init__(7, num_samples, sr=16000, duration=1.0,
                         seed=seed, feat_type=feat_type, **kwargs)


class ESC50(_SyntheticAudio):
    """ESC-50 environmental sounds: 50 classes (reference:
    audio/datasets/esc50.py)."""

    def __init__(self, mode="train", split=1, feat_type="raw",
                 archive=None, num_samples=400, **kwargs):
        seed = 50 if mode == "train" else 51
        super().__init__(50, num_samples, sr=16000, duration=1.0,
                         seed=seed, feat_type=feat_type, **kwargs)
