"""paddle.audio of the port (counterpart of ``paddle_tpu/audio``; the
reference's python/paddle/audio): feature layers over ``signal.stft``,
window and mel helpers, a stdlib-``wave`` IO backend and two synthetic
datasets."""
from . import backends, datasets, features, functional
from .backends import info, load, save

__all__ = ["functional", "features", "datasets", "backends", "load",
           "info", "save"]
