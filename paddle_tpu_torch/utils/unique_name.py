"""Unique name generator (counterpart of
``paddle_tpu/utils/unique_name.py``)."""
from __future__ import annotations

import contextlib
import threading


class _Generator(threading.local):
    def __init__(self):
        self.ids = {}
        self.prefix = ""


_gen = _Generator()


def generate(key: str) -> str:
    i = _gen.ids.get(key, 0)
    _gen.ids[key] = i + 1
    return f"{_gen.prefix}{key}_{i}"


def switch(new_generator=None):
    """Swap the counter state; pass a previously-returned state to
    RESTORE it (reference unique_name.switch contract)."""
    old = dict(_gen.ids)
    _gen.ids = dict(new_generator) if isinstance(new_generator, dict) \
        else {}
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old_ids, old_prefix = _gen.ids, _gen.prefix
    _gen.ids = {}
    if isinstance(new_generator, str):
        _gen.prefix = new_generator
    try:
        yield
    finally:
        _gen.ids, _gen.prefix = old_ids, old_prefix
