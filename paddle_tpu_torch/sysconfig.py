"""Build configuration paths (counterpart of ``paddle_tpu/sysconfig.py``)."""
from __future__ import annotations

import os

__all__ = ["get_include", "get_lib"]


def get_include():
    """The directory of the port's CUDA sources and headers (``csrc/``)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


def get_lib():
    """The directory the port's kernel libraries are built into
    (``build/`` at the repository root)."""
    from .kernels._build import BUILD_DIR
    return str(BUILD_DIR)
