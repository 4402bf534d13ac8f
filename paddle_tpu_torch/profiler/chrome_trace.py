"""Chrome-trace (trace_event) JSON export of a Profiler's window.

Counterpart of ``paddle_tpu/profiler/chrome_trace.py``. The host side is
the reference's: ``RecordEvent`` annotations (tid 0), eager op dispatch
spans (tid 1) and memory counter samples, one process row per rank. The
port adds the device side in the same file: the CUDA kernels, memcpys
and memsets the torch profiler saw (tid 2), moved onto the host store's
``time.perf_counter`` clock (``Profiler`` aligns the two clocks once a
trace), so one chrome://tracing / perfetto view shows both.

pid tagging: one process per rank (``_rank_info``).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional


def _rank_info():
    """(rank, world_size) of this process, in the reference's order:
    ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` when set, else
    ``torch.distributed``'s when a process group is up, else (0, 1)."""
    import torch.distributed as dist
    up = dist.is_available() and dist.is_initialized()
    rank = os.environ.get("PADDLE_TRAINER_ID")
    world = os.environ.get("PADDLE_TRAINERS_NUM")
    rank = int(rank) if rank is not None else (dist.get_rank() if up else 0)
    world = int(world) if world is not None else (
        dist.get_world_size() if up else 1)
    return rank, world


# thread lanes within a rank's process row
TID_USER = 0      # RecordEvent annotations
TID_DISPATCH = 1  # eager op dispatch spans
TID_DEVICE = 2    # CUDA activity (kernels, memcpy, memset)


def build_trace(profiler, worker_name: Optional[str] = None) -> dict:
    """Chrome trace dict for one Profiler's recorded window."""
    rank, world = _rank_info()
    pid = rank
    name = worker_name or f"rank{rank}"

    store_events = list(getattr(profiler._store, "events", []))
    rt = getattr(profiler, "_runtime_stats", None)
    spans = list(rt.ops.spans) if rt is not None else []
    mem = list(rt.memory.samples) if rt is not None else []
    device = list(getattr(profiler, "_device_events", []))

    # one common origin so user events, op spans, kernels and memory
    # counters line up; chrome-trace wants microseconds
    starts = ([s for _, s, _ in store_events] + [s for _, s, _ in spans]
              + [s for _, s, _ in device]
              + [m["t"] for m in mem if "t" in m])
    t0 = min(starts) if starts else 0.0

    def us(t):
        return round((t - t0) * 1e6, 3)

    events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": f"{name} (host, {world} rank"
                          f"{'s' if world != 1 else ''})"}},
        {"ph": "M", "name": "process_sort_index", "pid": pid, "tid": 0,
         "args": {"sort_index": rank}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": TID_USER,
         "args": {"name": "user annotations"}},
        {"ph": "M", "name": "thread_name", "pid": pid,
         "tid": TID_DISPATCH, "args": {"name": "op dispatch"}},
    ]
    if device:
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": TID_DEVICE,
                       "args": {"name": "device (CUDA activity)"}})
    for ev_name, s, e in store_events:
        events.append({"ph": "X", "cat": "user", "name": ev_name,
                       "pid": pid, "tid": TID_USER, "ts": us(s),
                       "dur": round((e - s) * 1e6, 3)})
    for op_name, s, e in spans:
        events.append({"ph": "X", "cat": "op", "name": op_name,
                       "pid": pid, "tid": TID_DISPATCH, "ts": us(s),
                       "dur": round((e - s) * 1e6, 3)})
    for k_name, s, e in device:
        events.append({"ph": "X", "cat": "kernel", "name": k_name,
                       "pid": pid, "tid": TID_DEVICE, "ts": us(s),
                       "dur": round((e - s) * 1e6, 3)})
    for m in mem:
        if "t" not in m:
            continue
        events.append({"ph": "C", "cat": "memory",
                       "name": f"memory ({m.get('source', '?')})",
                       "pid": pid, "tid": 0, "ts": us(m["t"]),
                       "args": {"bytes_in_use": m["bytes_in_use"]}})

    meta = {"rank": rank, "world_size": world,
            "step_num": getattr(profiler, "step_num", 0),
            "tool": "paddle_tpu_torch.profiler"}
    if rt is not None:
        meta["compiles"] = rt.compiles.compiles
        meta["compile_secs"] = round(rt.compiles.compile_secs, 4)
        if rt.ops.timeline_dropped:
            meta["op_spans_dropped"] = rt.ops.timeline_dropped
    device_trace = getattr(profiler, "last_device_trace_path", None)
    if device_trace:
        meta["device_trace"] = device_trace
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": meta}


def export_chrome_trace(profiler, path: str,
                        worker_name: Optional[str] = None) -> str:
    trace = build_trace(profiler, worker_name)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path
