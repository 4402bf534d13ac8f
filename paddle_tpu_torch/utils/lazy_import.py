"""try_import (counterpart of ``paddle_tpu/utils/lazy_import.py``)."""
from __future__ import annotations

import importlib


def try_import(module_name: str, err_msg: str = None):
    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(
            err_msg or f"required optional package {module_name!r} is "
            f"not installed; pip install {module_name}")
