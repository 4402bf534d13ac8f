"""paddle_tpu_torch.monitor — named counters, gauges and histograms.

Counterpart of ``paddle_tpu/monitor/__init__.py``, reduced to the
counters, gauges and log2 histograms the serving engines and the kernel
wrappers report through. The port keeps its own copy: it imports nothing
of the JAX package.

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
- ``kernels.flash.sdpa.{kernel,plain}[_mask]``, ``.dense_mask``,
  ``.core``: the route a ``scaled_dot_product_attention`` call took (the
  flash kernels / their plain versions, without or with key-mask bands;
  the plain core for a dense mask or ``use_flash=False``).
"""
from __future__ import annotations

import math
import threading
from typing import Dict

_lock = threading.Lock()
_counters: Dict[str, "Counter"] = {}
_gauges: Dict[str, "Gauge"] = {}
_histograms: Dict[str, "Histogram"] = {}


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


#: linear sub-buckets per power-of-two octave: a bucket is at most 1/16
#: of its value wide, so a percentile's midpoint estimate is within ~3.2 %
HIST_SUBBUCKETS = 16


def _hist_index(v: float) -> int:
    m, e = math.frexp(v)          # v = m * 2**e, m in [0.5, 1)
    return e * HIST_SUBBUCKETS + int((m * 2.0 - 1.0) * HIST_SUBBUCKETS)


def _hist_bounds(idx: int):
    e, s = divmod(idx, HIST_SUBBUCKETS)
    base = math.ldexp(1.0, e - 1)
    return (base * (1.0 + s / HIST_SUBBUCKETS),
            base * (1.0 + (s + 1) / HIST_SUBBUCKETS))


class Histogram:
    """Log2 histogram (octaves of 16 linear sub-buckets, sparse; the
    ``Histogram`` of the JAX package's monitor): O(1) ``record``, and
    ``percentile`` as a bucket midpoint clamped to the observed min and
    max. Values <= 0 land in a zero bucket."""

    __slots__ = ("name", "_buckets", "_zeros", "_count", "_min", "_max")

    def __init__(self, name: str = ""):
        self.name = name
        self._buckets: Dict[int, int] = {}
        self._zeros = 0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")

    def record(self, v: float) -> None:
        v = float(v)
        with _lock:
            self._count += 1
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if v <= 0.0:
                self._zeros += 1
            else:
                idx = _hist_index(v)
                self._buckets[idx] = self._buckets.get(idx, 0) + 1

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        """Value at percentile ``q`` (0..100)."""
        if self._count == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self._count))
        seen = self._zeros
        if rank <= seen:
            return max(0.0, self._min)
        val = self._max
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if rank <= seen:
                lo, hi = _hist_bounds(idx)
                val = (lo + hi) / 2.0
                break
        return min(max(val, self._min), self._max)

    def reset(self):
        self.__init__(self.name)

    def __repr__(self):
        return f"Histogram({self.name} n={self._count})"


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


def histogram(name: str) -> Histogram:
    """Get-or-create the named histogram."""
    h = _histograms.get(name)
    if h is None:
        with _lock:
            h = _histograms.setdefault(name, Histogram(name))
    return h


def snapshot() -> Dict[str, float]:
    """One flat dict of every counter and gauge value."""
    out: Dict[str, float] = {}
    for name, c in sorted(_counters.items()):
        out[name] = c.get()
    for name, g in sorted(_gauges.items()):
        out[name] = g.get()
    return out


def reset():
    """Zero every registered counter, gauge and histogram (the keys
    survive, so held references stay valid)."""
    for c in _counters.values():
        c.reset()
    for g in _gauges.values():
        g.reset()
    for h in _histograms.values():
        h.reset()
