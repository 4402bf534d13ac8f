from . import functional

__all__ = ["functional"]
