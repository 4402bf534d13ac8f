"""Core runtime: the device rule, and the surface ``Tensor`` / ``to_tensor``
the JAX package's ``core`` also exports (loaded on first use: the tensor
module imports the rest of the core)."""
from .device import resolve_device

__all__ = ["resolve_device", "Tensor", "to_tensor"]


def __getattr__(name):
    if name in ("Tensor", "to_tensor"):
        from . import tensor
        return getattr(tensor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
