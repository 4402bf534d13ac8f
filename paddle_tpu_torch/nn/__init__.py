from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import CrossEntropyLoss, Dropout, LayerNorm

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "CrossEntropyLoss", "Dropout", "LayerNorm"]
