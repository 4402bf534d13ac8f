"""Memory stats and named monitors (counterpart of
``paddle_tpu/device/monitor.py``).

Device memory is the CUDA caching allocator's: ``_device_stats`` maps
``torch.cuda.memory_stats()`` onto the JAX package's keys
(``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved``,
``peak_bytes_reserved``, ``bytes_limit``), and every memory function
reads through it. Without a visible GPU they raise: there is no device
memory to report, and a zero would hide the missing card.

The host's RSS and peak come from ``/proc/self/status`` and the named
int64 monitors are a locked dict, in plain Python, where the JAX package
reads both through its native ``csrc/monitor.cpp``.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch


def _cuda_index(device=None, what: str = "device memory") -> int:
    """The CUDA device index ``device`` names (None: the current GPU; an
    int, ``"gpu:1"``, ``"cuda:1"``, a ``CUDAPlace`` or a torch device).
    Raises without a visible GPU, naming the CPU opt-in."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is visible ({what} needs one): the port "
            f"runs on an NVIDIA GPU by default; call "
            f"paddle.set_device(\"cpu\") to run on the CPU, which has no "
            f"streams, events or device memory")
    if device is None:
        return torch.cuda.current_device()
    if isinstance(device, int):
        return device
    idx = getattr(device, "device_id", None)          # a Place
    if idx is not None:
        if getattr(device, "device_type", "gpu") != "gpu":
            raise ValueError(f"{device!r} is not a GPU place")
        return int(idx)
    dev = device if isinstance(device, torch.device) else torch.device(
        str(device).replace("gpu", "cuda"))
    if dev.type != "cuda":
        raise ValueError(f"{device!r} is not a GPU")
    return torch.cuda.current_device() if dev.index is None else dev.index


def _device_stats(device_id=None) -> Dict[str, int]:
    """THE device memory-stats reader: the CUDA allocator's counters under
    the JAX package's keys."""
    idx = _cuda_index(device_id)
    s = torch.cuda.memory_stats(idx)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(s.get("reserved_bytes.all.peak", 0)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(idx).total_memory)}


def memory_allocated(device=None) -> int:
    """Bytes the allocator holds for tensors on ``device`` now."""
    return _device_stats(device)["bytes_in_use"]


def max_memory_allocated(device=None) -> int:
    """The peak of memory_allocated since the last peak reset."""
    return _device_stats(device)["peak_bytes_in_use"]


def memory_reserved(device=None) -> int:
    """Bytes the allocator has reserved from the card (cached too)."""
    return _device_stats(device)["bytes_reserved"]


def max_memory_reserved(device=None) -> int:
    return _device_stats(device)["peak_bytes_reserved"]


def _proc_status_bytes(field: str) -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return -1


def host_memory_rss() -> int:
    """Current host RSS bytes (-1 if unavailable)."""
    return _proc_status_bytes("VmRSS:")


def host_memory_peak() -> int:
    """Peak host RSS bytes (-1 if unavailable)."""
    return _proc_status_bytes("VmHWM:")


_lock = threading.Lock()
_monitors: Dict[str, list] = {}      # name -> [sum, count, min, max]


def monitor_add(name: str, value: int) -> None:
    """Record a sample on the named int64 monitor."""
    v = int(value)
    with _lock:
        s = _monitors.get(name)
        if s is None:
            _monitors[name] = [v, 1, v, v]
        else:
            s[0] += v
            s[1] += 1
            s[2] = min(s[2], v)
            s[3] = max(s[3], v)


def monitor_get(name: str) -> Optional[dict]:
    """{sum, count, min, max} of the named monitor, None if unknown."""
    with _lock:
        s = _monitors.get(name)
        return None if s is None else dict(zip(("sum", "count", "min",
                                                "max"), s))


def monitor_reset(name: str) -> None:
    with _lock:
        _monitors.pop(name, None)
