"""@deprecated decorator (counterpart of
``paddle_tpu/utils/deprecated.py``)."""
from __future__ import annotations

import functools
import warnings


def deprecated(update_to: str = "", since: str = "", reason: str = "",
               level: int = 1):
    def decorator(func):
        msg = f"API {func.__module__}.{func.__name__} is deprecated"
        if since:
            msg += f" since {since}"
        if update_to:
            msg += f"; use {update_to} instead"
        if reason:
            msg += f" ({reason})"
        if level == 2:
            @functools.wraps(func)
            def blocked(*a, **k):
                raise RuntimeError(msg)
            return blocked

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return func(*args, **kwargs)
        return wrapper
    return decorator
