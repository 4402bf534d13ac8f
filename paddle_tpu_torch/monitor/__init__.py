"""paddle_tpu_torch.monitor — named counters and gauges.

Counterpart of ``paddle_tpu/monitor/__init__.py``, reduced to the
counter/gauge subset the serving engine and the kernel wrappers report
through. The port keeps its own copy: it imports nothing of the JAX
package.

    from paddle_tpu_torch import monitor
    monitor.counter("kernels.decode.paged_cuda").increase()
    monitor.gauge("serving.ttft_ms").set(12.5)
    monitor.snapshot()   # {'kernels.decode.paged_cuda': 1, ...}

Kernel-path counters (bumped by the wrappers, one per call):

- ``kernels.decode.paged_cuda`` / ``kernels.decode.paged_plain``: the
  single-token paged decode ran the CUDA kernel / the plain PyTorch
  version (CPU tensors only).
- ``kernels.decode.paged_gather``: a multi-token (prefill) paged step
  ran the plain gather + matmul path.
- ``kernels.flash.fwd_cuda`` / ``kernels.flash.fwd_plain``: the no-cache
  attention ran the CUDA flash forward kernel / its plain version.
- ``kernels.flash.bwd_cuda`` / ``kernels.flash.bwd_plain``: a flash
  backward ran the two CUDA backward kernels (dQ and dK/dV) / the plain
  backward.
- ``kernels.moe.grouped_ffn_fwd_cuda`` / ``_plain`` and
  ``kernels.moe.grouped_ffn_bwd_cuda`` / ``_plain``: the grouped expert
  FFN forward / backward ran the CUDA kernels / the plain versions.
- ``kernels.moe.dispatch_path.{pallas,scatter,einsum}`` and
  ``kernels.moe.decode_path.pallas``: which dispatch an MoE layer's
  forward (training) / serving decode-mode call ran; a layer that leaves
  the kernel path bumps ``...fallback.<reason>``. The Engine mirrors the
  decode counts into ``serving.moe.decode_path.*``.
"""
from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()
_counters: Dict[str, "Counter"] = {}
_gauges: Dict[str, "Gauge"] = {}


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def increase(self, n: int = 1) -> int:
        with _lock:
            self._value += n
            return self._value

    def get(self) -> int:
        return self._value

    def reset(self):
        self._value = 0

    def __repr__(self):
        return f"Counter({self.name}={self._value})"


class Gauge:
    """Last-value gauge."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> float:
        self._value = float(v)
        return self._value

    def get(self) -> float:
        return self._value

    def reset(self):
        self._value = 0.0

    def __repr__(self):
        return f"Gauge({self.name}={self._value})"


def counter(name: str) -> Counter:
    """Get-or-create the named counter."""
    c = _counters.get(name)
    if c is None:
        with _lock:
            c = _counters.setdefault(name, Counter(name))
    return c


def gauge(name: str) -> Gauge:
    """Get-or-create the named gauge."""
    g = _gauges.get(name)
    if g is None:
        with _lock:
            g = _gauges.setdefault(name, Gauge(name))
    return g


def snapshot() -> Dict[str, float]:
    """One flat dict of every counter and gauge value."""
    out: Dict[str, float] = {}
    for name, c in sorted(_counters.items()):
        out[name] = c.get()
    for name, g in sorted(_gauges.items()):
        out[name] = g.get()
    return out


def reset():
    """Zero every registered counter and gauge (the keys survive, so
    held references stay valid)."""
    for c in _counters.values():
        c.reset()
    for g in _gauges.values():
        g.reset()
