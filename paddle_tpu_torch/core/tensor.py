"""paddle.Tensor of the eager surface (counterpart of ``paddle_tpu/core/tensor.py``).

A ``Tensor`` wraps a ``torch.Tensor`` (``_data``) as the JAX one wraps a
``jax.Array``. It does not subclass ``torch.Tensor``: paddle's members
collide with torch's (``shape`` is a list, ``size`` an int property,
``dtype`` a paddle ``DType``), and torch's own code calls the torch ones.

torch autograd is the tape. A floating tensor is differentiable when its
``_data`` requires grad; ``stop_gradient`` reads and writes that flag
(a non-leaf set to ``stop_gradient = True`` is cut from the graph:
``_data`` becomes ``_data.detach()``, as torch refuses
``requires_grad_(False)`` on a non-leaf). Integer and bool tensors never
require grad; their ``stop_gradient`` is a plain flag, as the JAX
package just does not differentiate them. ``backward`` is
``torch.autograd.backward``; ``.grad`` wraps ``_data.grad`` (the same
wrapper each time) and accumulates across ``backward`` calls until
``clear_grad``. ``set_value``, ``fill_``, ``zero_`` and ``copy_`` write
a leaf in place under ``torch.no_grad()``, so an optimizer holding the
leaf sees the new values.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import dtype as dtype_mod
from . import place as place_mod
from .dtype import DType


def _is_float(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        raw = torch.from_numpy(np.array(a.view(
            np.uint16 if a.dtype.itemsize == 2 else np.uint8)))
        return raw.view(dtype_mod.dtype(a.dtype.name).torch_dtype)
    if a.dtype == np.object_:
        raise TypeError("to_tensor: object arrays have no tensor dtype")
    return torch.from_numpy(np.array(a, copy=True))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 and float8 come back as the
    ``ml_dtypes`` types the JAX package returns when ``ml_dtypes`` is
    installed, else as float32."""
    on_cpu = t.device.type == "cpu"
    # lazy conjugate / negative views (torch.fft's ihfft, imag of one)
    t = t.detach().cpu().resolve_conj().resolve_neg()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        try:
            import ml_dtypes
        except ImportError:
            return t.float().numpy()
        name = dtype_mod.from_torch(t.dtype).name
        view = torch.int16 if t.dtype == torch.bfloat16 else torch.uint8
        return t.view(view).numpy().view(getattr(ml_dtypes, name))
    # a CPU tensor's .numpy() shares its memory: copy, so a later
    # in-place op leaves the snapshot as it was (as the card's copy does)
    return t.numpy().copy() if on_cpu else t.numpy()


def _coerce(data, dt: Optional[DType], device) -> torch.Tensor:
    """Python / numpy / torch data -> a torch tensor with paddle's
    default-dtype rules (a float64 array or Python float -> the default
    float dtype, a Python int -> int64)."""
    if isinstance(data, Tensor):
        t = data._data.detach()
    elif isinstance(data, torch.Tensor):
        t = data.detach()
    elif isinstance(data, (bool, int, float)) and \
            torch.compiler.is_compiling():
        # a Python scalar under ``jit.to_static``: Dynamo cannot trace the
        # numpy path; torch.tensor gives numpy's dtype (bool, int64 or
        # float64, the last cast below)
        t = torch.tensor(data, dtype=torch.float64
                         if isinstance(data, float) else None)
        if dt is None and isinstance(data, float):
            t = t.to(dtype_mod.default_float_dtype().torch_dtype)
    else:
        a = np.asarray(data)
        t = _from_numpy(a)
        if dt is None and a.dtype == np.float64:
            t = t.to(dtype_mod.default_float_dtype().torch_dtype)
    if dt is not None and t.dtype != dt._require():
        t = t.to(dt.torch_dtype)
    if device is not None and t.device != device:
        t = t.to(device)
    return t


def _device_of(place) -> torch.device:
    if place is None:
        return place_mod.current_device()
    return place_mod.parse_place(place).torch_device()


class Tensor:
    """A multidimensional array on a GPU or the CPU with optional grad
    history (torch's)."""

    __slots__ = ("_data", "_sg", "name", "persistable", "_grad_wrap",
                 "__weakref__", "__dict__")

    def __init__(self, data=None, dtype=None, place=None, stop_gradient=True,
                 name=None, persistable=False):
        if data is None:
            data = []
        self._data = _coerce(data, dtype_mod.dtype(dtype)
                             if dtype is not None else None,
                             _device_of(place))
        self._sg = True
        self._grad_wrap = None
        self.name = name
        self.persistable = persistable
        self.stop_gradient = stop_gradient

    @classmethod
    def _from_data(cls, t: torch.Tensor, name=None):
        """Wrap a torch tensor as it is (no copy, no device move)."""
        obj = cls.__new__(cls)
        obj._data = t
        obj._sg = not t.requires_grad
        obj._grad_wrap = None
        obj.name = name
        obj.persistable = False
        return obj

    # -- basic properties ----------------------------------------------------
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    ndimension = ndim

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self) -> DType:
        return dtype_mod.from_torch(self._data.dtype)

    @property
    def place(self):
        return place_mod.place_of(self._data.device)

    @property
    def is_leaf(self):
        return self._data.grad_fn is None

    @property
    def T(self):
        from ..ops import manipulation
        return manipulation.t(self)

    @property
    def mT(self):
        from ..ops import manipulation
        perm = list(range(self.ndim))
        perm[-1], perm[-2] = perm[-2], perm[-1]
        return manipulation.transpose(self, perm)

    def dim(self):
        return self.ndim

    def element_size(self):
        return self._data.element_size()

    # -- data access ---------------------------------------------------------
    def numpy(self) -> np.ndarray:
        return to_numpy(self._data)

    def item(self, *args):
        return self.numpy().item(*args)

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __dlpack__(self, *a, **k):
        return self._data.detach().__dlpack__(*a, **k)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    # -- autograd ------------------------------------------------------------
    @property
    def stop_gradient(self):
        if _is_float(self._data):
            return not self._data.requires_grad
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        self._sg = value
        d = self._data
        if not _is_float(d):
            return
        if value and d.requires_grad:
            if d.grad_fn is not None:
                self._data = d.detach()
            else:
                d.requires_grad_(False)
        elif not value and not d.requires_grad:
            d.requires_grad_(True)

    @property
    def requires_grad(self):
        return not self.stop_gradient

    @requires_grad.setter
    def requires_grad(self, v):
        self.stop_gradient = not v

    @property
    def grad(self):
        d = self._data
        if d.grad_fn is not None or d.grad is None:
            return None
        w = self._grad_wrap
        if w is None:
            w = Tensor._from_data(d.grad, name=(self.name or "") + "@GRAD")
            self._grad_wrap = w
        elif w._data is not d.grad:
            w._data = d.grad
        return w

    @grad.setter
    def grad(self, value):
        self._data.grad = None if value is None else (
            value._data if isinstance(value, Tensor) else value)
        self._grad_wrap = value if isinstance(value, Tensor) else None

    def backward(self, grad_tensor=None, retain_graph=False):
        d = self._data
        if grad_tensor is not None:
            g = grad_tensor._data if isinstance(grad_tensor, Tensor) \
                else torch.as_tensor(grad_tensor, device=d.device)
        else:
            g = None if d.numel() == 1 else torch.ones_like(d)
        torch.autograd.backward(d, g, retain_graph=retain_graph)

    def register_hook(self, hook):
        def torch_hook(g):
            out = hook(Tensor._from_data(g))
            return out._data if isinstance(out, Tensor) else out
        return self._data.register_hook(torch_hook)

    def clear_grad(self, set_to_zero=False):
        d = self._data
        if set_to_zero and d.grad is not None:
            d.grad.zero_()
        else:
            d.grad = None
            self._grad_wrap = None

    clear_gradient = clear_grad

    def detach(self) -> "Tensor":
        return Tensor._from_data(self._data.detach(), name=self.name)

    def detach_(self) -> "Tensor":
        self.stop_gradient = True
        return self

    def clone(self) -> "Tensor":
        from ..ops import creation
        return creation.clone(self)

    # -- device / dtype movement --------------------------------------------
    def to(self, *args, **kwargs):
        t = self
        for a in list(args) + list(kwargs.values()):
            if a is None or isinstance(a, bool):
                continue
            if isinstance(a, DType) or (isinstance(a, str) and
                                        _is_dtype_str(a)):
                t = t.astype(a)
            else:
                dev = place_mod.parse_place(a).torch_device()
                t = Tensor._from_data(t._data.to(dev), name=t.name)
        return t

    def cpu(self):
        return Tensor._from_data(self._data.cpu(), name=self.name)

    def cuda(self, device_id=None, blocking=True):
        dev = place_mod.CUDAPlace(device_id or 0).torch_device()
        return Tensor._from_data(self._data.to(dev), name=self.name)

    def pin_memory(self):
        return self.cpu()

    def astype(self, dt):
        from ..ops import manipulation
        return manipulation.cast(self, dt)

    def cast(self, dt):
        return self.astype(dt)

    # -- value setters -------------------------------------------------------
    def _write(self, new: torch.Tensor):
        d = self._data
        if d.grad_fn is None:
            with torch.no_grad():
                d.copy_(new)
        else:
            self._data = new.detach()
        return self

    def set_value(self, value):
        new = _coerce(value, self.dtype, self._data.device)
        if tuple(new.shape) != tuple(self._data.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(new.shape)} "
                             f"vs {tuple(self._data.shape)}")
        return self._write(new)

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    def fill_(self, value):
        return self._write(torch.full_like(self._data, value))

    def zero_(self):
        return self._write(torch.zeros_like(self._data))

    # -- repr / python protocol ---------------------------------------------
    def __repr__(self):
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}{grad_info},\n       {self.numpy()!r})")

    __str__ = __repr__

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-D tensor")
        return self._data.shape[0]

    def __bool__(self):
        return bool(self._data.detach())

    def __int__(self):
        return int(self._data.detach())

    def __float__(self):
        return float(self._data.detach())

    def __index__(self):
        return int(self._data.detach())

    def __hash__(self):
        return id(self)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return str(self)


def _is_dtype_str(s: str) -> bool:
    try:
        dtype_mod.dtype(s)
        return True
    except (TypeError, ValueError):
        return False


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """paddle.to_tensor: a new tensor on ``place`` (the current place when
    None, which is the GPU unless ``set_device('cpu')`` was called)."""
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)
