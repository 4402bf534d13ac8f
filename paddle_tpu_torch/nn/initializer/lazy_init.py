"""Lazy parameter initialization (counterpart of
``paddle_tpu/nn/initializer/lazy_init.py``).

Under ``with LazyGuard():`` ``Layer.create_parameter`` records the
initializer on each new Parameter instead of running it (the parameter
holds zeros); ``param.initialize()`` runs it later.
"""
from __future__ import annotations

_state = {"in_lazy_mode": False}


def in_lazy_mode() -> bool:
    return _state["in_lazy_mode"]


class LazyGuard:
    """Context manager: construct Layers without running param initializers."""

    def __enter__(self):
        self._prev = _state["in_lazy_mode"]
        _state["in_lazy_mode"] = True
        return self

    def __exit__(self, *exc):
        _state["in_lazy_mode"] = self._prev
        return False
