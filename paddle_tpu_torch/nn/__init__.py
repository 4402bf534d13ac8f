from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import CrossEntropyLoss

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "CrossEntropyLoss"]
