"""Profiler core (counterpart of ``paddle_tpu/profiler/profiler.py``).

The scheduler and its states are the reference's. The device tracer is
``torch.profiler`` (unless ``timer_only``): READY prepares a
``torch.profiler.profile`` over the targets (the slow part, CUPTI's
set-up, happens before the recorded steps), RECORD starts it: CPU
activity always (it carries the clock anchor) and CUDA activity (CUPTI)
for ``ProfilerTarget.GPU``. The host store takes ``RecordEvent`` spans
while the schedule records, as the op dispatch spans are taken (the JAX
package's store also keeps those of the cycle's CLOSED and READY
steps). When a window closes, its
trace is written under ``log_dir`` (``*.pt.trace.json``, where the JAX
package's XPlane files go) and its CUDA activity joins the window as
(name, start, end) spans on the host store's ``time.perf_counter``
clock: ``export_chrome_tracing`` writes them in a lane of their own and
``summary()`` tables them by kernel. A device trace that cannot start
raises.
"""
from __future__ import annotations

import enum
import os
import time
import warnings
from collections import defaultdict
from typing import Callable, Iterable, Optional


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Step-keyed state schedule (the JAX package's make_scheduler)."""
    period = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def _default_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def _targets(targets) -> frozenset:
    """The checked target set: None is CPU + GPU; GPU without a visible
    GPU raises, naming the host-only set."""
    import torch
    chosen = frozenset(targets) if targets is not None else frozenset(
        (ProfilerTarget.CPU, ProfilerTarget.GPU))
    other = chosen - {ProfilerTarget.CPU, ProfilerTarget.GPU}
    if other:
        raise ValueError(f"profiler targets {sorted(t.name for t in other)} "
                         f"are not supported: the port profiles the CPU "
                         f"and NVIDIA GPUs")
    if ProfilerTarget.GPU in chosen and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible, so the GPU target cannot be "
            "traced (targets=None means CPU + GPU); pass "
            "targets=[ProfilerTarget.CPU] to profile the host only")
    return chosen


#: the zero-length annotation that ties the torch profiler's clock to
#: ``time.perf_counter`` once a trace
_ANCHOR = "paddle_tpu_torch::profiler_clock_anchor"


def kernel_base_name(name: str) -> str:
    """A CUDA kernel's name without its return type, scope, template
    arguments and parameter list (``void ns::k<8>(Args)`` -> ``k``);
    names that are not signatures (``Memcpy HtoD (Device -> Device)``)
    pass unchanged."""
    def cut(s, open_c, close_c):
        if not s.endswith(close_c):
            return s, False
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {close_c: 1, open_c: -1}.get(s[i], 0)
            if depth == 0:
                return s[:i], True
        return s, False

    s, had_args = cut(name.strip(), "(", ")")
    if had_args and (not s or not (s[-1].isalnum() or s[-1] in "_>")):
        return name
    s, _ = cut(s, "<", ">")
    return s.rpartition("::")[2].rpartition(" ")[2] or name


def device_spans(kineto_results, anchor_perf: float):
    """The CUDA activity of a finished torch profiler trace (kernels,
    memcpys, memsets; not the annotations' device ranges) as (kernel
    base name, start, end) on the ``time.perf_counter`` clock, aligned
    by the trace's ``_ANCHOR`` annotation, in start order."""
    from torch.autograd import DeviceType
    events = kineto_results.events()
    anchor = next((e for e in events if e.name() == _ANCHOR), None)
    if anchor is None:
        raise RuntimeError("the torch profiler trace lost its clock anchor "
                           f"({_ANCHOR})")
    a_ns = anchor.start_ns()          # integer ns first: no rounding
    # a record_function range is also reported on the device timeline
    # under its host name (gpu_user_annotation): that is not device work
    host_names = {e.name() for e in events
                  if e.device_type() != DeviceType.CUDA}
    spans = [(kernel_base_name(e.name()),
              anchor_perf + (e.start_ns() - a_ns) * 1e-9,
              anchor_perf + (e.end_ns() - a_ns) * 1e-9)
             for e in events if e.device_type() == DeviceType.CUDA
             and e.name() not in host_names]
    spans.sort(key=lambda s: s[1])
    return spans


class _HostEventStore:
    """In-process host event aggregation (the JAX package's store)."""

    def __init__(self):
        self.events = []  # (name, start, end)

    def add(self, name, start, end):
        self.events.append((name, start, end))

    def aggregate(self):
        return aggregate_spans(self.events)


def aggregate_spans(spans):
    """{name: calls, total_ms, min_ms, max_ms, avg_ms} of (name, start,
    end) spans in seconds."""
    agg = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
    for name, s, e in spans:
        d = (e - s) * 1e3  # ms
        a = agg[name]
        a[0] += 1
        a[1] += d
        a[2] = min(a[2], d)
        a[3] = max(a[3], d)
    return {k: dict(calls=v[0], total_ms=v[1], min_ms=v[2],
                    max_ms=v[3], avg_ms=v[1] / max(v[0], 1))
            for k, v in agg.items()}


_current_store: Optional[_HostEventStore] = None


class RecordEvent:
    """User annotation: a ``torch.profiler.record_function`` range (on the
    torch profiler's trace, where the JAX package opens a
    ``jax.profiler.TraceAnnotation``) and a span in the host store."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._rf = None
        self._start = None

    def begin(self):
        self.__enter__()

    def end(self):
        self.__exit__(None, None, None)

    def __enter__(self):
        import torch
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*(exc or (None, None, None)))
            self._rf = None
        if _current_store is not None and self._start is not None:
            _current_store.add(self.name, self._start, end)
        return False


class Profiler:
    """Reference-shaped Profiler.

        with paddle.profiler.Profiler(
                targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                on_trace_ready=export_chrome_tracing("out")) as p:
            for batch in loader:
                train_step(...)
                p.step()

    ``record_shapes`` passes to ``torch.profiler``; ``profile_memory``
    turns on the per-step memory sampler (the Memory view), not the torch
    profiler's allocation events.
    """

    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler=None, on_trace_ready=None, record_shapes=False,
                 profile_memory=False, timer_only=False, log_dir=None,
                 **kw):
        self._targets = _targets(targets)
        if callable(scheduler):
            self._scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)) and len(scheduler) == 2:
            lo, hi = scheduler
            self._scheduler = make_scheduler(
                closed=max(lo, 0), ready=0, record=hi - lo, repeat=1)
        else:
            self._scheduler = _default_scheduler
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._record_shapes = record_shapes
        self._log_dir = log_dir or os.environ.get(
            "PADDLE_PROFILER_LOG_DIR", "./profiler_log")
        self.step_num = 0
        self._state = ProfilerState.CLOSED
        self._tracing = False
        self._recording = False
        self._fired_in_step = False
        self._store = _HostEventStore()
        self._tprof = None          # the open torch.profiler.profile
        self._anchor_perf = None
        self._device_events = []    # the window's CUDA activity spans
        from .stats import RuntimeStats
        self._runtime_stats = RuntimeStats(record_timeline=True,
                                           profile_memory=profile_memory)
        self.last_trace_path = None         # set by export_chrome_tracing
        self.last_device_trace_path = None  # the torch profiler's trace

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        self._state = self._scheduler(self.step_num)
        self._transit()

    def stop(self):
        global _current_store
        # batched NaN checking must not leave queued flags unreported
        # past the end of a profiled run, and a raised NaN report must
        # not leak an open device trace
        from ..core.dispatch import flush_nan_checks
        try:
            flush_nan_checks()
        finally:
            had_trace = self._tracing
            if self._tracing:
                self._stop_trace()
            self._discard_prepared()
            self._runtime_stats.stop()
            self._recording = False
            # fire only for a cycle still open at stop(); completed
            # cycles already fired in step()
            if self._on_trace_ready is not None and (
                    had_trace or (self._timer_only
                                  and not self._fired_in_step)):
                self._on_trace_ready(self)
            _current_store = None

    def step(self, num_samples: Optional[int] = None):
        prev = self._state
        # step boundary housekeeping BEFORE the state transition, so the
        # closing step's builds and memory land in its own bucket and
        # queued NaN flags are reported against the step that made them
        from ..core.dispatch import flush_nan_checks
        flush_nan_checks()
        if self._recording:
            self._runtime_stats.on_step(self.step_num)
        self.step_num += 1
        new_state = self._scheduler(self.step_num)
        if prev == ProfilerState.RECORD_AND_RETURN:
            # end of a recording cycle: close the trace (even if the next
            # cycle records again: cycles must not merge) and hand the
            # result to on_trace_ready
            if self._tracing:
                self._stop_trace()
            if self._on_trace_ready is not None:
                self._on_trace_ready(self)
                self._fired_in_step = True
            # the next cycle starts with fresh collectors, a fresh host
            # store and no device spans
            self._runtime_stats.reset_window()
            self._recording = False
            self._store = _HostEventStore()
            self._device_events = []
            global _current_store
            _current_store = None
        if new_state != self._state or prev == \
                ProfilerState.RECORD_AND_RETURN:
            self._state = new_state
            self._transit()

    def _transit(self):
        global _current_store
        recording = self._state in (ProfilerState.RECORD,
                                    ProfilerState.RECORD_AND_RETURN)
        # host-side telemetry runs whenever the schedule records, in
        # timer_only mode too, which skips only the device tracer below
        if recording and not self._recording:
            self._runtime_stats.start()
            self._recording = True
            _current_store = self._store
        elif not recording and self._recording:
            self._runtime_stats.stop()
            self._recording = False
            _current_store = None
        want_trace = recording and not self._timer_only
        if want_trace and not self._tracing:
            self._start_trace()
        elif not want_trace and self._tracing:
            self._stop_trace()
        if self._state == ProfilerState.READY and not self._timer_only:
            self._prepare_trace()
        elif not want_trace:
            self._discard_prepared()

    def _prepare_trace(self):
        """Build the torch profiler and set its tracers up (CUPTI's
        initialisation), without recording."""
        if self._tprof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if ProfilerTarget.GPU in self._targets:
            acts.append(ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts,
                                      record_shapes=self._record_shapes)
        with warnings.catch_warnings():
            # one torch profiler per window: nothing to accumulate
            warnings.filterwarnings("ignore", message=".*clears events")
            prof.prepare_trace()
        self._tprof = prof

    def _discard_prepared(self):
        """Close a prepared trace that never started (torch closes one
        by starting and stopping it)."""
        if self._tprof is not None and not self._tracing:
            prof, self._tprof = self._tprof, None
            prof.start_trace()
            prof.stop_trace()

    def _start_trace(self):
        import torch
        os.makedirs(self._log_dir, exist_ok=True)
        self._prepare_trace()
        self._tprof.start_trace()
        self._tracing = True
        t0 = time.perf_counter()
        with torch.profiler.record_function(_ANCHOR):
            t1 = time.perf_counter()
        self._anchor_perf = t0 + (t1 - t0) / 2

    def _stop_trace(self):
        from .chrome_trace import _rank_info
        prof, self._tprof = self._tprof, None
        self._tracing = False
        prof.stop_trace()
        results = prof.profiler.kineto_results
        if ProfilerTarget.GPU in self._targets:
            self._device_events.extend(device_spans(results,
                                                    self._anchor_perf))
        rank, _ = _rank_info()
        path = os.path.join(self._log_dir,
                            f"rank{rank}_step{self.step_num}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.last_device_trace_path = path

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- reporting -----------------------------------------------------------
    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms", views=None, row_limit=100):
        """Multi-view report: Overview + Operator + Device + Memory + UDF
        by default, any subset via ``views=SummaryView.* | [...]``, rows
        ordered by ``sorted_by`` (a SortedKeys member)."""
        from .profiler_statistic import StatisticData
        return StatisticData(self).build_table(
            sorted_by=sorted_by, views=views, row_limit=row_limit,
            time_unit=time_unit)

    @property
    def statistic_data(self):
        from .profiler_statistic import StatisticData
        return StatisticData(self)

    @property
    def runtime_stats(self):
        """The window's RuntimeStats (op tracer, compile tracker, memory
        samples): see profiler/stats.py."""
        return self._runtime_stats

    def shape_churn_report(self, min_signatures: int = 8):
        return self._runtime_stats.ops.shape_churn_report(min_signatures)

    @property
    def profiler_result_dir(self):
        return self._log_dir


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready factory: writes a chrome://tracing / perfetto JSON of
    the window (user, dispatch and device lanes, memory counters, rank
    tagging) that load_profiler_result reads back. TRACE_LOCATION.txt
    names the torch profiler's own trace directory (``log_dir``)."""
    def handler(prof: Profiler):
        from . import chrome_trace
        os.makedirs(dir_name, exist_ok=True)
        marker = os.path.join(dir_name, "TRACE_LOCATION.txt")
        with open(marker, "w") as f:
            f.write(prof.profiler_result_dir + "\n")
        rank, _ = chrome_trace._rank_info()
        name = worker_name or f"rank{rank}"
        path = os.path.join(dir_name,
                            f"{name}_step{prof.step_num}.json")
        prof.last_trace_path = chrome_trace.export_chrome_trace(
            prof, path, worker_name=name)
    return handler


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    return export_chrome_tracing(dir_name, worker_name)


def load_profiler_result(filename: str):
    """Load an exported chrome-trace JSON back into its dict. Raises
    ValueError for a file that isn't a chrome trace."""
    import json
    with open(filename) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "traceEvents" not in data:
        raise ValueError(
            f"{filename} is not a chrome-trace export (no traceEvents)")
    return data
