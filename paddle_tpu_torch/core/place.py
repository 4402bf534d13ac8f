"""Places of the eager surface (counterpart of ``paddle_tpu/core/place.py``).

A place names a torch device: ``CPUPlace()`` the CPU, ``CUDAPlace(n)``
GPU n. The current place, where ``to_tensor``, the creation ops and new
parameters put their data, is ``cuda:0`` until ``set_device`` changes
it; resolving it without a visible GPU raises through
``core.device.resolve_device`` (nothing moves to the CPU on its own).
``TPUPlace`` and ``XPUPlace`` raise: the port runs on NVIDIA GPUs.
"""
from __future__ import annotations

import torch

from .device import resolve_device


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        if self.device_type == "cpu":
            return "Place(cpu)"
        return f"Place(gpu:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    device_type = "cpu"

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "gpu"

    def torch_device(self):
        return resolve_device(f"cuda:{self.device_id}")


CUDAPinnedPlace = CPUPlace


class _Unsupported(Place):
    def __init__(self, device_id: int = 0):
        raise RuntimeError(
            f"{type(self).__name__} is not supported: the port runs on "
            f"NVIDIA GPUs (CUDAPlace) or, on request, the CPU (CPUPlace)")


class CustomPlace(Place):
    """A plug-in device kind (``CustomPlace("npu", 0)``). The port has no
    plug-in runtime: the place constructs, prints and compares as the
    JAX package's does, and ``set_device`` of it raises as for any
    unknown kind."""

    def __init__(self, device_type: str, device_id: int = 0):
        super().__init__(device_id)
        self.device_type = device_type

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def torch_device(self):
        raise ValueError(f"unknown device {self.device_type!r}: the port "
                         f"runs on 'gpu' (default) or, on request, 'cpu'")


class TPUPlace(_Unsupported):
    pass


class XPUPlace(_Unsupported):
    pass


_current_place: Place = CUDAPlace(0)


def _get_current_place() -> Place:
    return _current_place


def current_device() -> torch.device:
    """The torch device of the current place (raises without a GPU
    unless the CPU was asked for)."""
    return _current_place.torch_device()


def place_of(device: torch.device) -> Place:
    if device.type == "cpu":
        return CPUPlace()
    return CUDAPlace(device.index or 0)


def parse_place(device) -> Place:
    """A Place, a torch device or a string ('cpu', 'gpu', 'gpu:1',
    'cuda:0') -> a Place."""
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return place_of(device)
    s = str(device)
    kind, _, idx = s.partition(":")
    if kind == "cpu":
        return CPUPlace()
    if kind in ("gpu", "cuda"):
        return CUDAPlace(int(idx) if idx else 0)
    if kind in ("tpu", "xpu"):
        raise RuntimeError(f"device {s!r} is not supported: the port runs "
                           f"on 'gpu' (default) or, on request, 'cpu'")
    raise ValueError(f"unknown device {s!r}")


def set_device(device) -> Place:
    """paddle.set_device('gpu' | 'gpu:n' | 'cpu'): a GPU place is checked
    at once (RuntimeError without a visible GPU)."""
    global _current_place
    place = parse_place(device)
    place.torch_device()
    _current_place = place
    return place


def get_device() -> str:
    p = _current_place
    return "cpu" if p.device_type == "cpu" else f"gpu:{p.device_id}"


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False
