"""Runtime flag registry.

Counterpart of ``paddle_tpu/core/flags.py``, reduced to what the port's
flags need: a flag is defined in Python with its default, overridden by
the ``FLAGS_<name>`` environment variable when the flag is defined, and
read or written through ``get_flag`` / ``get_flags`` / ``set_flags``.
The serving flags (``serving_fault_*``, ``serving_debug_invariants``)
are defined in ``inference/reliability.py``; the eager surface's NaN
check flags below, ``sdpa_use_flash`` in ``nn/functional/attention.py``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List


class _Flag:
    __slots__ = ("name", "default", "value", "type", "help")

    def __init__(self, name, default, help=""):
        self.name = name
        self.default = default
        self.type = type(default)
        self.help = help
        env = os.environ.get(f"FLAGS_{name}")
        self.value = default if env is None else _parse(env, self.type)


def _parse(s: str, ty):
    if ty is bool:
        return s.lower() in ("1", "true", "yes", "on")
    if ty is int:
        return int(s)
    if ty is float:
        return float(s)
    return s


_registry: Dict[str, _Flag] = {}


def define_flag(name: str, default, help: str = "") -> _Flag:
    """Register ``name`` (once; a second definition keeps the first)."""
    if name not in _registry:
        _registry[name] = _Flag(name, default, help)
    return _registry[name]


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _registry:
        raise ValueError(f"Flag {name} is not registered")
    return key


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flags by name (with or without the ``FLAGS_`` prefix); a
    string value is parsed to the flag's type."""
    for k, v in flags.items():
        fl = _registry[_key(k)]
        fl.value = _parse(v, fl.type) if isinstance(v, str) else fl.type(v)


def get_flag(name: str):
    return _registry[_key(name)].value


def all_flags() -> List[str]:
    """The name of every registered flag."""
    return list(_registry)


def get_flags(flags) -> Dict[str, Any]:
    """{name: value} of one flag name or a list of them."""
    if isinstance(flags, str):
        flags = [flags]
    return {f: get_flag(f) for f in flags}


define_flag("check_nan_inf", False,
            "scan every eager op's floating outputs for NaN/Inf")
define_flag("check_nan_inf_level", 0, "0: raise on NaN/Inf; >0: print only")
define_flag("check_nan_inf_batch", 1,
            "ops per NaN-check host sync: 1 raises at the offending op; "
            "larger batches read the flags of N ops in one sync, "
            "reporting up to N ops late")
