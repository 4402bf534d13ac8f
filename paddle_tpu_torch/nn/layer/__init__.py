from .common import Dropout
from .loss import CrossEntropyLoss
from .norm import LayerNorm

__all__ = ["CrossEntropyLoss", "Dropout", "LayerNorm"]
