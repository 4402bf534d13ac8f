from .loss import CrossEntropyLoss

__all__ = ["CrossEntropyLoss"]
