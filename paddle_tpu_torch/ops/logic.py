"""Comparison / logical ops (counterpart of ``paddle_tpu/ops/logic.py``)."""
from __future__ import annotations

import torch

from ..core.dispatch import run_op_nodiff, unwrap, wrap
from .math import _pair


def _cmp(op_name, fn):
    def body(a, b):
        return fn(*_pair(a, b))

    def op(x, y, name=None):
        return run_op_nodiff(op_name, body, [x, y])
    op.__name__ = op_name
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)
bitwise_left_shift = _cmp("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = _cmp("bitwise_right_shift", torch.bitwise_right_shift)


def logical_not(x, name=None):
    return run_op_nodiff("logical_not", torch.logical_not, [x])


def bitwise_not(x, name=None):
    return run_op_nodiff("bitwise_not", torch.bitwise_not, [x])


def bitwise_invert(x, name=None):
    return bitwise_not(x, name)


def equal_all(x, y, name=None):
    a, b = unwrap(x), unwrap(y)
    return wrap(torch.tensor(bool(a.shape == b.shape and torch.equal(a, b)),
                             device=a.device))


def is_same_shape(x, y):
    return tuple(unwrap(x).shape) == tuple(unwrap(y).shape)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = unwrap(x), unwrap(y)
    return wrap(torch.tensor(torch.allclose(a, b, float(rtol), float(atol),
                                            equal_nan), device=a.device))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return run_op_nodiff("isclose", lambda a, b: torch.isclose(
        a, b, float(rtol), float(atol), equal_nan), [x, y])


def _dims(a, axis):
    if axis is None:
        return tuple(range(a.dim()))
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return run_op_nodiff("all", lambda a: torch.all(
        a.bool(), dim=_dims(a, axis), keepdim=keepdim), [x])


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return run_op_nodiff("any", lambda a: torch.any(
        a.bool(), dim=_dims(a, axis), keepdim=keepdim), [x])


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return run_op_nodiff("isin", lambda a, b: torch.isin(
        a, b, assume_unique=assume_unique, invert=invert), [x, test_x])


def less(x, y, name=None):
    return less_than(x, y)
