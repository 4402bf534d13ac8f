"""paddle.incubate.autotune (counterpart of
``paddle_tpu/incubate/autotune.py``): the kernel / layout / dataloader
tuning switches. The config is recorded and read back with
``get_config``; the port's kernels pick their routes by shape and dtype
and read none of it."""
from __future__ import annotations

import json
import warnings

__all__ = ["set_config", "get_config"]

_config = {"kernel": {"enable": False},
           "layout": {"enable": False},
           "dataloader": {"enable": False}}


def set_config(config=None):
    """A dict or the path of a JSON file; None enables every field."""
    global _config
    if config is None:
        _config = {k: {"enable": True} for k in _config}
        return
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    for key, val in config.items():
        if key not in _config:
            warnings.warn(f"autotune: unknown config field {key}")
            continue
        _config[key].update(val)


def get_config():
    return _config
