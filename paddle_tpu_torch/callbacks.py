"""paddle.callbacks (counterpart of ``paddle_tpu/callbacks.py``): the
hapi callback classes."""
from .hapi.callbacks import (Callback, EarlyStopping, LRScheduler,
                             ModelCheckpoint, ProgBarLogger,
                             ReduceLROnPlateau, TelemetryLogger, VisualDL,
                             WandbCallback)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "ReduceLROnPlateau", "TelemetryLogger",
           "VisualDL", "WandbCallback"]
