"""DLPack interop (counterpart of ``paddle_tpu/utils/dlpack.py``), on
``torch.utils.dlpack``: no copy either way.

Modern DLPack passes the producer object (anything with ``__dlpack__``
/ ``__dlpack_device__``), not a raw capsule: ``to_dlpack`` returns the
Tensor's torch tensor (detached, the same storage), which
``torch.from_dlpack``, ``np.from_dlpack`` and ``jax.numpy.from_dlpack``
take; ``from_dlpack`` takes any such object (a numpy, JAX, CuPy or
torch array, or a Tensor) and wraps it as a Tensor on its device.
"""
from __future__ import annotations

import torch.utils.dlpack

from ..core.dispatch import unwrap, wrap


def to_dlpack(x):
    """Tensor -> a DLPack-protocol array sharing its memory."""
    return unwrap(x).detach()


def from_dlpack(ext):
    """Any ``__dlpack__`` object (or a Tensor) -> a Tensor sharing its
    memory."""
    ext = unwrap(ext)
    if not hasattr(ext, "__dlpack__"):
        raise TypeError(
            "from_dlpack needs an object implementing the DLPack "
            "protocol (__dlpack__); pass the source array/tensor itself "
            "rather than a raw PyCapsule")
    return wrap(torch.utils.dlpack.from_dlpack(ext))
