"""Model hub (counterpart of ``paddle_tpu/hub.py``; the reference's
python/paddle/hub.py list / help / load).

Only ``source="local"`` (a directory holding a ``hubconf.py``, loaded
with ``importlib``) works: the github and gitee sources raise, as the
JAX package's do, and nothing reaches the network.
"""
from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]

_HUB_CONF = "hubconf.py"


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, _HUB_CONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {_HUB_CONF} in {repo_dir}")
    spec = importlib.util.spec_from_file_location("hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["hubconf"] = mod
    spec.loader.exec_module(mod)
    return mod


def _check_source(source):
    if source not in ("local", "github", "gitee"):
        raise ValueError(
            f"unknown source {source}: expected local/github/gitee")
    if source != "local":
        raise RuntimeError(
            "remote hub sources need network access, which the hub does "
            "not use; clone the repo and use source='local'")


def list(repo_dir, source="github", force_reload=False):  # noqa: A001
    """List callable entrypoints exposed by a hub repo's hubconf.py."""
    if os.path.isdir(repo_dir):
        source = "local"
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return [n for n in dir(mod)
            if callable(getattr(mod, n)) and not n.startswith("_")]


def help(repo_dir, model, source="github", force_reload=False):  # noqa: A001
    """Docstring of a hub entrypoint."""
    if os.path.isdir(repo_dir):
        source = "local"
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return getattr(mod, model).__doc__


def load(repo_dir, model, source="github", force_reload=False, **kwargs):
    """Instantiate a hub entrypoint."""
    if os.path.isdir(repo_dir):
        source = "local"
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    if not hasattr(mod, model):
        raise ValueError(f"model {model} not found in {repo_dir}")
    return getattr(mod, model)(**kwargs)
