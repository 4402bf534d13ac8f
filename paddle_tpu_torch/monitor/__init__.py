"""paddle_tpu_torch.monitor — named counters, gauges and histograms.

Counterpart of ``paddle_tpu/monitor/__init__.py``, reduced to the
counters, gauges and log2 histograms the serving engines and the kernel
wrappers report through. The port keeps its own copy: it imports nothing
of the JAX package.

    from paddle_tpu_torch import monitor
    monitor.counter("kernels.decode.paged_cuda").increase()
    monitor.gauge("serving.ttft_ms").set(12.5)
    monitor.snapshot()   # {'kernels.decode.paged_cuda': 1, ...}
    monitor.scope("replica0").counter("serving.steps").increase()
    # -> serving.steps and serving.replica0.steps

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

What the port builds or captures at run time (``profiler/stats.py``'s
``compile_event``, always on): ``kernels.builds`` / ``kernels.build_secs``
(kernel libraries compiled by ``nvcc``) and ``cuda.graph_captures`` /
``cuda.graph_capture_secs`` (the Engine's multi-tick CUDA graphs);
``dispatch.ops`` counts the ops a ``Profiler`` window recorded.

Under ``jit.to_static`` (a Dynamo trace) a counter's write is skipped:
a compiled graph runs no Python, so a count bumped by traced code would
count the trace, not the calls, and the tracer cannot enter the
registry's lock. The kernel counters above are bumped inside the flash
custom ops, which run at every call of a compiled graph; the ``sdpa``
route counters (bumped by traced Python) count eager calls only.

The registry is always live; ``PADDLE_TPU_MONITOR=1`` (or ``enable()``)
gates only emission: hapi's per-epoch ``TelemetryLogger`` line.
"""
from __future__ import annotations

import math
import os
import threading
from typing import Dict, Optional

from torch.compiler import is_compiling as _tracing

_lock = threading.Lock()
_counters: Dict[str, "Counter"] = {}
_gauges: Dict[str, "Gauge"] = {}
_histograms: Dict[str, "Histogram"] = {}
_enabled_override: Optional[bool] = None


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def increase(self, n: int = 1) -> int:
        if _tracing():
            return self._value
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
    """Last-value gauge with running count, mean, min and max."""

    __slots__ = ("name", "_value", "_count", "_total", "_min", "_max")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._count = 0
        self._total = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def _observe(self, v: float):
        self._count += 1
        self._total += v
        self._min = min(self._min, v)
        self._max = max(self._max, v)

    def set(self, v: float) -> float:
        v = float(v)
        with _lock:
            self._value = v
            self._observe(v)
        return v

    def add(self, v: float) -> float:
        """Accumulate into the last value (duration totals)."""
        v = float(v)
        with _lock:
            self._value += v
            self._observe(v)
            return self._value

    def get(self) -> float:
        return self._value

    def stats(self) -> Dict[str, float]:
        if not self._count:
            return dict(last=0.0, count=0, mean=0.0, min=0.0, max=0.0)
        return dict(last=self._value, count=self._count,
                    mean=self._total / self._count, min=self._min,
                    max=self._max)

    def reset(self):
        self.__init__(self.name)

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

    __slots__ = ("name", "_buckets", "_zeros", "_count", "_sum", "_min",
                 "_max")

    def __init__(self, name: str = ""):
        self.name = name
        self._buckets: Dict[int, int] = {}
        self._zeros = 0
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def record(self, v: float) -> None:
        v = float(v)
        with _lock:
            self._count += 1
            self._sum += v
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

    @property
    def sum(self) -> float:
        """Sum of the recorded values."""
        return self._sum

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s buckets into this histogram (exact: the same
        as one that recorded both streams). Returns self."""
        with _lock:
            self._count += other._count
            self._sum += other._sum
            self._zeros += other._zeros
            self._min = min(self._min, other._min)
            self._max = max(self._max, other._max)
            for idx, n in other._buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + n
        return self

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

    def stats(self) -> Dict[str, float]:
        """count, mean, min, max, p50, p90 and p99 (zeros when empty)."""
        if not self._count:
            return dict(count=0, mean=0.0, min=0.0, max=0.0, p50=0.0,
                        p90=0.0, p99=0.0)
        return dict(count=self._count, mean=self._sum / self._count,
                    min=self._min, max=self._max,
                    p50=self.percentile(50), p90=self.percentile(90),
                    p99=self.percentile(99))

    def reset(self):
        self.__init__(self.name)

    def __repr__(self):
        return f"Histogram({self.name} n={self._count})"


def counter(name: str) -> Counter:
    """Get-or-create the named counter."""
    c = _counters.get(name)
    if c is None:
        if _tracing():
            return Counter(name)       # unregistered: its writes are skipped
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


class _Pair:
    """Fan-out wrapper a Scope hands back: every write lands on both the
    unlabeled aggregate instrument and its ``serving.<label>.…`` twin;
    reads come from the aggregate."""

    __slots__ = ("_agg", "_scoped")

    def __init__(self, agg, scoped):
        self._agg = agg
        self._scoped = scoped

    def __getattr__(self, attr):
        agg_fn = getattr(self._agg, attr)
        scoped_fn = getattr(self._scoped, attr)
        if not callable(agg_fn):
            return agg_fn

        def both(*a, **kw):
            out = agg_fn(*a, **kw)
            scoped_fn(*a, **kw)
            return out
        return both


class Scope:
    """Label-scoped view of the registry. ``scope("replica0")`` returns
    an emitter whose ``counter`` / ``gauge`` / ``histogram`` write BOTH
    the unlabeled aggregate (``serving.ttft_ms``) and the labeled twin
    (``serving.replica0.ttft_ms``)."""

    __slots__ = ("label",)

    def __init__(self, label: str):
        self.label = label

    def scoped_name(self, name: str) -> str:
        """serving.x.y -> serving.<label>.x.y (the label slots in after
        the ``serving.`` namespace, so prefix filters over the unlabeled
        keys never match a labeled twin)."""
        if name.startswith("serving."):
            return f"serving.{self.label}." + name[len("serving."):]
        return f"{self.label}.{name}"

    def _pair(self, getter, name: str):
        return _Pair(getter(name), getter(self.scoped_name(name)))

    def counter(self, name: str):
        return self._pair(counter, name)

    def gauge(self, name: str):
        return self._pair(gauge, name)

    def histogram(self, name: str):
        return self._pair(histogram, name)


class _Unscoped:
    """``scope(None)``: the registry's own get-or-create functions, so an
    unlabeled emitter costs what a bare ``monitor.counter`` call does."""

    label = None
    counter = staticmethod(counter)
    gauge = staticmethod(gauge)
    histogram = staticmethod(histogram)


def scope(label: Optional[str]):
    """Labeled emitter over the registry (see Scope); ``scope(None)``
    writes the unlabeled names only, at no extra cost."""
    return _Unscoped if label is None else Scope(str(label))


def counters() -> Dict[str, int]:
    """Every counter's value (no gauges)."""
    return {name: c.get() for name, c in list(_counters.items())}


def snapshot(detail: bool = False) -> Dict[str, object]:
    """One flat dict of every counter and gauge value. With
    ``detail=True`` a gauge is its running stats dict and every histogram
    joins as its stats dict (count, mean, min, max, p50, p90, p99)."""
    out: Dict[str, object] = {}
    for name, c in sorted(_counters.items()):
        out[name] = c.get()
    for name, g in sorted(_gauges.items()):
        out[name] = g.stats() if detail else g.get()
    if detail:
        for name, h in sorted(_histograms.items()):
            out[name] = h.stats()
    return out


def histograms() -> Dict[str, Dict[str, float]]:
    """Every histogram that holds a value: {name: count, p50, p90, p99,
    mean, min, max} (the JAX monitor's ``snapshot(detail=True)`` entries
    for histograms)."""
    return {name: h.stats() for name, h in sorted(_histograms.items())
            if h.count}


def reset():
    """Zero every registered counter, gauge and histogram (the keys
    survive, so held references stay valid)."""
    for c in _counters.values():
        c.reset()
    for g in _gauges.values():
        g.reset()
    for h in _histograms.values():
        h.reset()


def enabled() -> bool:
    """True when telemetry emission is on: ``PADDLE_TPU_MONITOR=1`` in
    the environment, or an explicit ``enable()``."""
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get("PADDLE_TPU_MONITOR", "0").lower() in (
        "1", "true", "yes", "on")


def enable():
    global _enabled_override
    _enabled_override = True


def disable():
    global _enabled_override
    _enabled_override = False


def _clear_override():
    """Fall back to the environment variable."""
    global _enabled_override
    _enabled_override = None
