"""paddle.hapi of the port (counterpart of ``paddle_tpu/hapi``):
``Model``, the callbacks, ``summary`` and ``flops``."""
from . import callbacks
from .callbacks import (Callback, EarlyStopping, LRScheduler,
                        ModelCheckpoint, ProgBarLogger, TelemetryLogger)
from .dynamic_flops import flops
from .model import Model
from .summary import summary

__all__ = ["Callback", "EarlyStopping", "LRScheduler", "Model",
           "ModelCheckpoint", "ProgBarLogger", "TelemetryLogger",
           "callbacks", "flops", "summary"]
