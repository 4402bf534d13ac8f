from . import nn

__all__ = ["nn"]
