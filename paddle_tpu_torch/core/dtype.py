"""Data types of the eager surface (counterpart of ``paddle_tpu/core/dtype.py``).

A paddle ``DType`` is a name plus the ``torch.dtype`` that holds it
(``to_torch`` / ``from_torch``). ``pstring`` and ``raw`` are type tags
with no torch backing: asking for their torch dtype raises. The float8
types map to torch's, which many eager torch ops do not implement; such
an op raises torch's own error.
"""
from __future__ import annotations

import numpy as np
import torch


class DType:
    """A framework dtype: canonical name + torch dtype (None for a tag)."""

    __slots__ = ("name", "torch_dtype")

    def __init__(self, name: str, torch_dtype):
        self.name = name
        self.torch_dtype = torch_dtype

    def __repr__(self):
        return f"paddle.{self.name}"

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        try:
            return self.name == dtype(other).name
        except (TypeError, ValueError):
            return NotImplemented

    def __hash__(self):
        return hash(self.name)

    def _require(self):
        if self.torch_dtype is None:
            raise TypeError(f"paddle.{self.name} is a type tag with no "
                            f"tensor storage")
        return self.torch_dtype

    @property
    def is_floating_point(self):
        return self.torch_dtype is not None and self.torch_dtype.is_floating_point

    @property
    def is_integer(self):
        return self.torch_dtype is not None and not (
            self.torch_dtype.is_floating_point or self.torch_dtype.is_complex
            or self.torch_dtype == torch.bool)

    @property
    def is_complex(self):
        return self.torch_dtype is not None and self.torch_dtype.is_complex

    @property
    def itemsize(self):
        return self._require().itemsize


bool_ = DType("bool", torch.bool)
uint8 = DType("uint8", torch.uint8)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
float16 = DType("float16", torch.float16)
bfloat16 = DType("bfloat16", torch.bfloat16)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)
float8_e4m3fn = DType("float8_e4m3fn", torch.float8_e4m3fn)
float8_e5m2 = DType("float8_e5m2", torch.float8_e5m2)
pstring = DType("pstring", None)
raw = DType("raw", None)

_ALL = [bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
        float64, complex64, complex128, float8_e4m3fn, float8_e5m2]
_BY_NAME = {d.name: d for d in _ALL + [pstring, raw]}
_BY_NAME.update({"bool_": bool_, "float": float32, "int": int32,
                 "half": float16, "double": float64})
_BY_TORCH = {d.torch_dtype: d for d in _ALL}


def dtype(d) -> DType:
    """Coerce a DType, a name ('float32', 'paddle.float32'), a torch or
    numpy dtype or a Python type to a DType."""
    if isinstance(d, DType):
        return d
    if isinstance(d, torch.dtype):
        return from_torch(d)
    if isinstance(d, str):
        short = d.split(".")[-1]
        if short in _BY_NAME:
            return _BY_NAME[short]
        return dtype(np.dtype(d))
    if d is bool:
        return bool_
    if d is int:
        return int64
    if d is float:
        return float32
    name = np.dtype(d).name
    if name in _BY_NAME:
        return _BY_NAME[name]
    raise TypeError(f"unsupported dtype {d!r}")


def to_torch(d) -> torch.dtype:
    return dtype(d)._require()


def from_torch(td: torch.dtype) -> DType:
    try:
        return _BY_TORCH[td]
    except KeyError:
        raise TypeError(f"torch dtype {td} has no paddle counterpart")


_default_dtype = float32


def set_default_dtype(d):
    global _default_dtype
    d = dtype(d)
    if not (d.is_floating_point or d.is_complex):
        raise TypeError(
            f"set_default_dtype only supports floating point dtypes, got {d}")
    _default_dtype = d


def get_default_dtype() -> str:
    return _default_dtype.name


def default_float_dtype() -> DType:
    return _default_dtype


def is_floating_point_dtype(d) -> bool:
    return dtype(d).is_floating_point


def promote_types(a, b) -> DType:
    return from_torch(torch.promote_types(to_torch(a), to_torch(b)))


def iinfo(d):
    return torch.iinfo(to_torch(d))


def finfo(d):
    return torch.finfo(to_torch(d))
