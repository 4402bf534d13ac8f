"""Summary statistics: SortedKeys/SummaryView + the table builders.

Counterpart of ``paddle_tpu/profiler/profiler_statistic.py``: one table
per SummaryView, rows sorted by a SortedKeys member. OperatorView rows
come from the eager dispatch tracer (profiler/stats.py), MemoryView from
the per-step memory samples, UDFView from the RecordEvent spans and
OverView from the window totals and the run-time build tracker. The
port adds the device view (DeviceView / KernelView): each CUDA kernel
the torch profiler saw, by base name, with its launches and total /
average / min / max device ms. The GPU* sort keys order the device view
by its device times; on the host views they alias the host numbers (an
op's kernels run after its dispatch returns).
"""
from __future__ import annotations

import enum
from typing import Dict, List, Tuple


class SortedKeys(enum.Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(enum.Enum):
    """Report views (reference: profiler/profiler_statistic.py
    SummaryView)."""

    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


# SortedKeys -> aggregate field (the device view's fields are device ms,
# the host views' host ms).
_SORT_FIELD = {
    SortedKeys.CPUTotal: "total_ms", SortedKeys.GPUTotal: "total_ms",
    SortedKeys.CPUAvg: "avg_ms", SortedKeys.GPUAvg: "avg_ms",
    SortedKeys.CPUMax: "max_ms", SortedKeys.GPUMax: "max_ms",
    SortedKeys.CPUMin: "min_ms", SortedKeys.GPUMin: "min_ms",
}


def sort_field(sorted_by) -> str:
    if sorted_by is None:
        return "total_ms"
    if isinstance(sorted_by, SortedKeys):
        return _SORT_FIELD[sorted_by]
    if isinstance(sorted_by, str):  # tolerate "CPUTotal" / "total_ms"
        if sorted_by in SortedKeys.__members__:
            return _SORT_FIELD[SortedKeys[sorted_by]]
        return sorted_by
    raise TypeError(f"sorted_by must be a SortedKeys, got {sorted_by!r}")


def sort_items(agg: Dict[str, dict], sorted_by=None) -> List[Tuple[str,
                                                                   dict]]:
    """Rows of an aggregate {name: stat-dict} ordered by the requested
    key, largest first (the reference convention for every key)."""
    field = sort_field(sorted_by)
    return sorted(agg.items(), key=lambda kv: -kv[1].get(field, 0.0))


def _table(title: str, headers: List[str], rows: List[List[str]],
           widths: List[int]) -> str:
    def fmt(cells):
        return "".join(f"{c:<{w}}" if i == 0 else f"{c:>{w}}"
                       for i, (c, w) in enumerate(zip(cells, widths)))
    sep = "-" * sum(widths)
    lines = [f"---- {title} ----", fmt(headers), sep]
    lines += [fmt(r) for r in rows]
    return "\n".join(lines)


# stats are aggregated in ms; time_unit rescales at render time
_UNIT_SCALE = {"ms": 1.0, "s": 1e-3, "us": 1e3, "ns": 1e6}
_EVENT_W = [36, 8, 12, 12, 12, 12]


def _unit_scale(time_unit: str) -> float:
    if time_unit not in _UNIT_SCALE:
        raise ValueError(f"time_unit must be one of "
                         f"{sorted(_UNIT_SCALE)}, got {time_unit!r}")
    return _UNIT_SCALE[time_unit]


def _event_cols(unit: str):
    return ["name", "calls", f"total({unit})", f"avg({unit})",
            f"min({unit})", f"max({unit})"]


def _event_rows(agg, sorted_by, row_limit, scale):
    rows = []
    for name, st in sort_items(agg, sorted_by)[:row_limit]:
        rows.append([name[:35], str(st["calls"])]
                    + [f"{st[k] * scale:.3f}"
                       for k in ("total_ms", "avg_ms", "min_ms",
                                 "max_ms")])
    return rows


def event_table(agg: Dict[str, dict], sorted_by=None, row_limit=100,
                title="UserDefined Summary", time_unit="ms") -> str:
    """RecordEvent aggregate table (all four stats + min, reference
    UDFView)."""
    if not agg:
        return f"---- {title} ----\n(no host events recorded — wrap " \
               "code in RecordEvent)"
    scale = _unit_scale(time_unit)
    return _table(title, _event_cols(time_unit),
                  _event_rows(agg, sorted_by, row_limit, scale),
                  _EVENT_W)


def kernel_table(kernel_agg: Dict[str, dict], sorted_by=None,
                 row_limit=100, time_unit="ms") -> str:
    """DeviceView: the window's CUDA activity by kernel base name
    (launches, device time)."""
    if not kernel_agg:
        return "---- Device Summary ----\n(no CUDA activity recorded — " \
               "trace with targets including ProfilerTarget.GPU)"
    scale = _unit_scale(time_unit)
    headers = ["kernel", "launches", f"total({time_unit})",
               f"avg({time_unit})", f"min({time_unit})",
               f"max({time_unit})"]
    return _table("Device Summary (CUDA activity)", headers,
                  _event_rows(kernel_agg, sorted_by, row_limit, scale),
                  _EVENT_W)


def operator_table(op_stats, sorted_by=None, row_limit=100,
                   time_unit="ms") -> str:
    """OperatorView over the eager dispatch tracer ({name: OpStat})."""
    if not op_stats:
        return "---- Operator Summary ----\n(no ops dispatched in the " \
               "profiled window)"
    scale = _unit_scale(time_unit)
    agg = {name: st.as_dict() for name, st in op_stats.items()}
    headers = _event_cols(time_unit) + ["signatures"]
    widths = _EVENT_W + [12]
    rows = []
    for name, st in sort_items(agg, sorted_by)[:row_limit]:
        rows.append([name[:35], str(st["calls"])]
                    + [f"{st[k] * scale:.3f}"
                       for k in ("total_ms", "avg_ms", "min_ms",
                                 "max_ms")]
                    + [str(st["distinct_signatures"])])
    return _table("Operator Summary (host dispatch)", headers, rows,
                  widths)


def memory_table(samples: List[dict]) -> str:
    """MemoryView over the per-step samples."""
    if not samples:
        return "---- Memory Summary ----\n(no samples — pass " \
               "profile_memory=True and call Profiler.step())"
    headers = ["step", "source", "bytes_in_use", "peak_bytes"]
    widths = [8, 12, 18, 18]
    rows = [[str(s["step"]), s.get("source", "?"),
             f"{s['bytes_in_use']:,}", f"{s['peak_bytes_in_use']:,}"]
            for s in samples[-50:]]
    return _table("Memory Summary", headers, rows, widths)


def overview_table(profiler) -> str:
    """OverView: window wall time, event/op totals, device time, run-time
    builds."""
    agg = profiler._store.aggregate()
    rt = getattr(profiler, "_runtime_stats", None)
    rows = [
        ["profiler steps", str(profiler.step_num)],
        ["user events", str(sum(v["calls"] for v in agg.values()))],
    ]
    if rt is not None:
        op_calls = sum(st.calls for st in rt.ops.stats.values())
        op_ms = sum(st.total_s for st in rt.ops.stats.values()) * 1e3
        rows += [
            ["window wall (s)", f"{rt.wall_s:.3f}"],
            ["eager op dispatches", str(op_calls)],
            ["eager dispatch (ms)", f"{op_ms:.3f}"],
            ["builds and captures", str(rt.compiles.compiles)],
            ["build and capture (s)", f"{rt.compiles.compile_secs:.3f}"],
        ]
    device = getattr(profiler, "_device_events", [])
    if device:
        rows += [["device activities", str(len(device))],
                 ["device busy (ms)",
                  f"{sum(e - s for _, s, e in device) * 1e3:.3f}"]]
        churn = rt.ops.shape_churn_report()
        if churn:
            worst = churn[0]
            rows.append(["shape-churn suspects",
                         f"{len(churn)} (worst: {worst['op']} x"
                         f"{worst['distinct_signatures']} sigs)"])
    return _table("Overview", ["item", "value"], rows, [28, 40])


class StatisticData:
    """Aggregated view over a Profiler's host events, runtime stats and
    device activity."""

    def __init__(self, profiler):
        from .profiler import aggregate_spans
        self._profiler = profiler
        self._agg = profiler._store.aggregate()
        rt = getattr(profiler, "_runtime_stats", None)
        self.op_stats = rt.ops.stats if rt is not None else {}
        self.memory_samples = rt.memory.samples if rt is not None else []
        #: {kernel base name: launches (calls), total/avg/min/max device ms}
        self.kernel_stats = aggregate_spans(
            getattr(profiler, "_device_events", []))

    def items(self):
        return self._agg.items()

    def __getitem__(self, name):
        return self._agg[name]

    def build_table(self, sorted_by=None, views=None, row_limit=100,
                    time_unit="ms") -> str:
        """One section per requested view (default: OverView +
        OperatorView + DeviceView + MemoryView + UDFView)."""
        if views is None:
            views = [SummaryView.OverView, SummaryView.OperatorView,
                     SummaryView.DeviceView, SummaryView.MemoryView,
                     SummaryView.UDFView]
        elif isinstance(views, SummaryView):
            views = [views]
        parts = []
        for v in views:
            if v == SummaryView.OverView:
                parts.append(overview_table(self._profiler))
            elif v == SummaryView.OperatorView:
                parts.append(operator_table(self.op_stats, sorted_by,
                                            row_limit,
                                            time_unit=time_unit))
            elif v in (SummaryView.KernelView, SummaryView.DeviceView):
                parts.append(kernel_table(self.kernel_stats, sorted_by,
                                          row_limit, time_unit=time_unit))
            elif v in (SummaryView.MemoryView,
                       SummaryView.MemoryManipulationView):
                parts.append(memory_table(self.memory_samples))
            elif v in (SummaryView.UDFView, SummaryView.ModelView,
                       SummaryView.DistributedView):
                parts.append(event_table(self._agg, sorted_by, row_limit,
                                         time_unit=time_unit))
        return "\n\n".join(parts)
