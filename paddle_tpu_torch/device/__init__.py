"""Device API (counterpart of ``paddle_tpu/device/__init__.py``).

The port's accelerator is the NVIDIA GPU. ``Stream``, ``Event``,
``current_stream``, ``set_stream``, ``stream_guard`` and ``synchronize``
are real ``torch.cuda`` streams and events (the JAX package hands out
ordering tokens: XLA orders its own work); ``paddle.device.cuda`` holds
them with the memory functions, which read the CUDA caching allocator
(``device/monitor.py``). Without a visible GPU, ``Stream()``,
``Event()`` and the memory functions raise, naming
``paddle.set_device("cpu")``; ``device_count()`` is 0.

    s = paddle.device.Stream()
    with paddle.device.stream_guard(s):
        y = x @ w                     # queued on s
    e = s.record_event()
    paddle.device.current_stream().wait_event(e)
"""
from __future__ import annotations

import contextlib

import torch

from ..core.place import (CPUPlace, CUDAPlace, Place, TPUPlace,  # noqa: F401
                          XPUPlace, _get_current_place, get_device,
                          is_compiled_with_cuda, is_compiled_with_tpu,
                          is_compiled_with_xpu, set_device)
from ..core.place import place_of as _place_of
from .monitor import _cuda_index

#: paddle stream priorities (1 high, 2 normal) -> torch's (-1 high, 0)
_PRIORITY = {1: -1, 2: 0}


def get_all_device_type():
    return ["cpu"] + (["gpu"] if device_count() else [])


def get_all_custom_device_type():
    return []


def get_available_device():
    return ["cpu"] + [f"gpu:{i}" for i in range(device_count())]


def get_available_custom_device():
    return []


def device_count():
    """Visible GPUs (0 without one)."""
    return torch.cuda.device_count()


def _torch_stream(stream):
    return stream.stream_base if isinstance(stream, Stream) else stream


class Stream:
    """A CUDA stream (``torch.cuda.Stream`` underneath, ``stream_base``).
    ``priority`` 1 is high, 2 normal."""

    def __init__(self, device=None, priority=2, stream_base=None):
        if stream_base is None:
            if priority not in _PRIORITY:
                raise ValueError(f"stream priority must be 1 (high) or 2 "
                                 f"(normal), got {priority!r}")
            idx = _cuda_index(device, "a CUDA stream")
            stream_base = torch.cuda.Stream(idx, priority=_PRIORITY[priority])
        self.stream_base = stream_base
        self.device = _place_of(stream_base.device)

    @property
    def cuda_stream(self) -> int:
        return self.stream_base.cuda_stream

    def synchronize(self):
        self.stream_base.synchronize()

    def wait_event(self, event):
        self.stream_base.wait_event(event.event_base)

    def wait_stream(self, stream):
        self.stream_base.wait_stream(_torch_stream(stream))

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event

    def query(self) -> bool:
        return self.stream_base.query()

    def __eq__(self, other):
        return isinstance(other, Stream) and \
            self.stream_base == other.stream_base

    def __hash__(self):
        return hash(self.stream_base)

    def __repr__(self):
        return f"<paddle.device.Stream {self.stream_base}>"


class Event:
    """A CUDA event (``torch.cuda.Event`` underneath, ``event_base``)."""

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        _cuda_index(None, "a CUDA event")
        self.event_base = torch.cuda.Event(enable_timing=enable_timing,
                                           blocking=blocking,
                                           interprocess=interprocess)

    def record(self, stream=None):
        self.event_base.record(None if stream is None
                               else _torch_stream(stream))

    def query(self) -> bool:
        return self.event_base.query()

    def synchronize(self):
        self.event_base.synchronize()

    def elapsed_time(self, end_event) -> float:
        """Milliseconds between this event and ``end_event`` (both
        recorded, with ``enable_timing=True``)."""
        return self.event_base.elapsed_time(end_event.event_base)


def synchronize(device=None):
    """Wait for all work on ``device`` (default: the current place; the
    CPU place has nothing queued)."""
    if device is None:
        place = _get_current_place()
        if place.device_type == "cpu":
            return
        device = place.device_id
    elif str(device) == "cpu" or isinstance(device, CPUPlace):
        return
    torch.cuda.synchronize(_cuda_index(device, "a device to synchronize"))


def current_stream(device=None) -> Stream:
    """The current CUDA stream of ``device`` (default: the current GPU)."""
    idx = _cuda_index(device, "the current CUDA stream")
    return Stream(stream_base=torch.cuda.current_stream(idx))


def set_stream(stream) -> Stream:
    """Make ``stream`` current on its device; returns the stream that
    was current there."""
    prev = current_stream(stream.device.device_id)
    torch.cuda.set_stream(_torch_stream(stream))
    return prev


@contextlib.contextmanager
def stream_guard(stream=None):
    """Queue the block's CUDA work on ``stream`` (None: no change)."""
    if stream is None:
        yield
        return
    with torch.cuda.stream(_torch_stream(stream)):
        yield


def get_cudnn_version():
    """cuDNN's version as an int (90100 for 9.1.0), None without cuDNN."""
    return torch.backends.cudnn.version() if \
        torch.backends.cudnn.is_available() else None


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_ipu():
    return False


def is_compiled_with_cinn():
    """The port compiles no graphs with CINN."""
    return False


def is_compiled_with_custom_device(device_name=None):
    """The port has no custom-device plugins."""
    return False


def is_compiled_with_distribute():
    return torch.distributed.is_available()


class IPUPlace:
    def __init__(self, *a):
        raise RuntimeError("IPU is not supported: the port runs on NVIDIA "
                           "GPUs or, on request, the CPU")


from . import monitor  # noqa: E402
from .monitor import (max_memory_allocated, max_memory_reserved,  # noqa: E402
                      memory_allocated, memory_reserved)
from . import cuda  # noqa: E402
from . import xpu  # noqa: E402
