"""Runtime telemetry: op-dispatch stats, run-time builds, memory.

Counterpart of ``paddle_tpu/profiler/stats.py``:

* per-op dispatch counts, host seconds and INPUT SIGNATURES
  (``OpDispatchTracer``, on ``dispatch.OP_TIMING_HOOKS`` and
  ``OP_OBSERVERS``): an op whose signature set keeps growing sees a new
  shape every step (dynamic lengths, growing caches);
* what the port builds or captures at run time (``CompileTracker``): the
  port compiles no XLA programs, so its compiles are the kernel
  libraries ``kernels/_build.py`` compiles with ``nvcc`` and the CUDA
  graphs ``inference/decode_graph.py`` captures. Each site makes one
  ``compile_event`` call, which always bumps the monitor counters
  (``kernels.builds`` / ``kernels.build_secs``, ``cuda.graph_captures`` /
  ``cuda.graph_capture_secs``) and fans out to the trackers of the open
  profiler windows;
* memory watermarks sampled at ``Profiler.step()`` (``MemorySampler``;
  ``read_memory`` reads the ``device`` module: the CUDA allocator's
  stats on a GPU place, the host's RSS on the CPU, labelled by
  ``source``).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .. import monitor
from ..core.dispatch import dtype_name

#: kind of run-time build -> (its monitor counter, its seconds gauge)
COMPILE_COUNTERS = {
    "kernel_build": ("kernels.builds", "kernels.build_secs"),
    "graph_capture": ("cuda.graph_captures", "cuda.graph_capture_secs"),
}


class OpStat:
    """Aggregate for one op name across a tracing window."""

    __slots__ = ("name", "calls", "total_s", "min_s", "max_s",
                 "signatures", "out_dtypes")

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0
        self.signatures: Dict[tuple, int] = OrderedDict()
        self.out_dtypes: Dict[str, int] = {}

    def record(self, dt: float, sig: tuple):
        self.calls += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)
        self.signatures[sig] = self.signatures.get(sig, 0) + 1

    @property
    def avg_s(self) -> float:
        return self.total_s / max(self.calls, 1)

    def as_dict(self) -> dict:
        return dict(calls=self.calls, total_ms=self.total_s * 1e3,
                    avg_ms=self.avg_s * 1e3,
                    min_ms=(0.0 if self.calls == 0 else self.min_s * 1e3),
                    max_ms=self.max_s * 1e3,
                    distinct_signatures=len(self.signatures))


class OpDispatchTracer:
    """Observes the eager dispatch path through dispatch.OP_TIMING_HOOKS
    (counts, host seconds, input signatures) and dispatch.OP_OBSERVERS
    (output dtypes). start()/stop() are idempotent; with
    record_timeline=True every dispatch also lands as a span for the
    chrome-trace exporter (at most ``timeline_limit``)."""

    def __init__(self, record_timeline: bool = False,
                 timeline_limit: int = 100_000):
        self.stats: Dict[str, OpStat] = {}
        self.record_timeline = record_timeline
        self.timeline_limit = timeline_limit
        self.spans: List[Tuple[str, float, float]] = []  # (name, start, end)
        self.timeline_dropped = 0
        self._active = False
        #: {op: distinct signatures} at the first step boundary
        self._sigs_at_first_step: Optional[Dict[str, int]] = None

    # -- hook bodies ---------------------------------------------------------
    def _on_op(self, name: str, dt: float, sig: tuple):
        st = self.stats.get(name)
        if st is None:
            st = self.stats[name] = OpStat(name)
        st.record(dt, sig)
        monitor.counter("dispatch.ops").increase()
        if self.record_timeline:
            end = time.perf_counter()
            if len(self.spans) < self.timeline_limit:
                self.spans.append((name, end - dt, end))
            else:
                self.timeline_dropped += 1

    def _on_out(self, name: str, leaves):
        st = self.stats.get(name)
        if st is None:
            st = self.stats[name] = OpStat(name)
        for a in leaves:
            key = dtype_name(a.dtype)
            st.out_dtypes[key] = st.out_dtypes.get(key, 0) + 1

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        from ..core import dispatch
        if self._active:
            return self
        dispatch.OP_TIMING_HOOKS.append(self._on_op)
        dispatch.OP_OBSERVERS.append(self._on_out)
        self._active = True
        return self

    def stop(self):
        from ..core import dispatch
        if not self._active:
            return self
        for lst, h in ((dispatch.OP_TIMING_HOOKS, self._on_op),
                       (dispatch.OP_OBSERVERS, self._on_out)):
            if h in lst:
                lst.remove(h)
        self._active = False
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def on_step(self):
        """A step boundary: the first one fixes each op's signature count
        that later growth is read against."""
        if self._sigs_at_first_step is None:
            self._sigs_at_first_step = {
                name: len(st.signatures) for name, st in self.stats.items()}

    # -- reports -------------------------------------------------------------
    def shape_churn_report(self, min_signatures: int = 8) -> List[dict]:
        """Ops whose input-signature set keeps growing, worst first: at
        least ``min_signatures`` distinct signatures and, once a step
        boundary was seen (``on_step``), more than at the first one. Each
        new signature is a shape the op's kernels (and any CUDA graph or
        cache keyed on it) meet for the first time. (The JAX package's
        report has no step test: an O1 loop's ``cast`` of ten weight
        shapes, all met in its first step, is a row there.)"""
        first = self._sigs_at_first_step
        rows = []
        for name, st in self.stats.items():
            nsig = len(st.signatures)
            if nsig >= min_signatures and (
                    first is None or nsig > first.get(name, 0)):
                rows.append(dict(
                    op=name, calls=st.calls, distinct_signatures=nsig,
                    signatures_per_call=nsig / max(st.calls, 1),
                    example_signatures=[
                        "x".join(s) if isinstance(s, tuple) else str(s)
                        for s in list(st.signatures)[:3]],
                ))
        rows.sort(key=lambda r: -r["distinct_signatures"])
        return rows


class CompileTracker:
    """Counts run-time builds (kernel libraries, CUDA graph captures) and
    their seconds inside a window, fed by ``compile_event``. Keeps a
    per-step series so Profiler.step() can attribute builds to steps: a
    steady loop shows 0 after warmup."""

    def __init__(self):
        self.compiles = 0
        self.compile_secs = 0.0
        self.per_step: List[int] = []
        self._step_base = 0
        self._active = False

    def _on_compile(self, dur: float):
        if not self._active:
            return
        self.compiles += 1
        self.compile_secs += dur

    def start(self):
        if not self._active:
            self._active = True
            _active_trackers.append(self)
        return self

    def stop(self):
        if self._active:
            self._active = False
            if self in _active_trackers:
                _active_trackers.remove(self)
        return self

    def on_step(self):
        """Close the current step's attribution window."""
        self.per_step.append(self.compiles - self._step_base)
        self._step_base = self.compiles

    def steady_state_recompiles(self, warmup_steps: int = 1) -> int:
        """Builds after the warmup steps: zero in a healthy fixed-shape
        loop."""
        return sum(self.per_step[warmup_steps:]) + (
            self.compiles - self._step_base if len(self.per_step)
            >= warmup_steps else 0)

    def as_dict(self) -> dict:
        return dict(compiles=self.compiles,
                    compile_secs=round(self.compile_secs, 4),
                    per_step=list(self.per_step))


def read_memory() -> dict:
    """One memory snapshot: {'source', 'bytes_in_use',
    'peak_bytes_in_use', 'bytes_limit'}. On a GPU place (the current
    one) the CUDA caching allocator's stats through
    ``device.monitor._device_stats`` (``source`` "device": allocated
    bytes, their peak since the last ``reset_peak_memory_stats``, the
    card's memory); on the CPU place the host's RSS and its peak
    (``source`` "host_rss")."""
    from ..core.place import _get_current_place
    from ..device import monitor as device_monitor
    place = _get_current_place()
    if place.device_type == "gpu":
        stats = device_monitor._device_stats(place.device_id)
        return dict(source="device",
                    bytes_in_use=stats["bytes_in_use"],
                    peak_bytes_in_use=stats["peak_bytes_in_use"],
                    bytes_limit=stats["bytes_limit"])
    rss = device_monitor.host_memory_rss()
    peak = device_monitor.host_memory_peak()
    return dict(source="host_rss" if rss > 0 else "none",
                bytes_in_use=max(rss, 0),
                peak_bytes_in_use=max(peak, rss, 0), bytes_limit=0)


class MemorySampler:
    """Memory watermarks per profiler step (read_memory() per
    Profiler.step() when profile_memory=True)."""

    def __init__(self):
        self.samples: List[dict] = []

    def sample(self, step: int):
        s = read_memory()
        s["step"] = step
        s["t"] = time.perf_counter()
        self.samples.append(s)
        monitor.gauge("memory.bytes_in_use").set(s["bytes_in_use"])
        return s

    def peak(self) -> int:
        return max((s["peak_bytes_in_use"] for s in self.samples),
                   default=0)


class RuntimeStats:
    """The bundle a Profiler owns: one op tracer + compile tracker +
    memory sampler sharing a lifecycle."""

    def __init__(self, record_timeline: bool = True,
                 profile_memory: bool = False):
        self.ops = OpDispatchTracer(record_timeline=record_timeline)
        self.compiles = CompileTracker()
        self.memory = MemorySampler()
        self.profile_memory = profile_memory
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None

    def start(self):
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._t1 = None  # window reopened: wall_s runs live again
        self.ops.start()
        self.compiles.start()
        return self

    def stop(self):
        self.ops.stop()
        self.compiles.stop()
        self._t1 = time.perf_counter()
        return self

    def on_step(self, step: int):
        self.ops.on_step()
        self.compiles.on_step()
        if self.profile_memory:
            self.memory.sample(step)

    def reset_window(self):
        """Fresh collectors for the next scheduler cycle: cycles must not
        merge in the exported trace (each RECORD_AND_RETURN hands
        on_trace_ready a self-contained window)."""
        record_timeline = self.ops.record_timeline
        self.ops.stop()
        self.compiles.stop()
        self.ops = OpDispatchTracer(record_timeline=record_timeline)
        self.compiles = CompileTracker()
        self.memory = MemorySampler()
        self._t0 = None
        self._t1 = None

    @property
    def wall_s(self) -> float:
        if self._t0 is None:
            return 0.0
        return (self._t1 or time.perf_counter()) - self._t0


#: the CompileTrackers of the open profiler windows
_active_trackers: List[CompileTracker] = []


def compile_event(kind: str, seconds: float):
    """One run-time build of ``kind`` (a key of ``COMPILE_COUNTERS``) that
    took ``seconds``: bumps its monitor counter and seconds gauge (always
    on, so ``TelemetryLogger`` reads them with no profiler) and every
    active ``CompileTracker``."""
    counter, gauge = COMPILE_COUNTERS[kind]
    monitor.counter(counter).increase()
    monitor.gauge(gauge).add(seconds)
    for t in list(_active_trackers):
        t._on_compile(seconds)
