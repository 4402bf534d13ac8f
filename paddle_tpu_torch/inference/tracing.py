"""Per-request span timelines for the serving stack.

The port's copy of ``paddle_tpu/inference/tracing.py`` (which holds no
device code). Every request the Engine touches accumulates a host-truth
span log: QUEUED, each PREFILL slice, PREEMPTED, DECODE
(tick-aggregated), MIGRATING (kept in the vocabulary for the fleet), and
a terminal FINISHED / FAILED(reason) marker. Spans are recorded on the
engine's injectable clock, so a replay on a virtual clock produces the
same timelines run over run; span context is plain serializable host
state (a list of dicts on ``Request.spans``), so it rides
``snapshot()`` / ``restore()`` untouched.

The timeline contract (what ``validate_timeline`` checks):

* the first span is QUEUED (every request enters through a queue);
* spans are CONTIGUOUS: each span's ``t0_ms`` equals the previous
  span's ``t1_ms`` (no gaps, no overlaps; zero-length spans are legal,
  a virtual clock is constant within one tick);
* exactly one terminal span (FINISHED or FAILED) and it is last;
* a FAILED terminal span carries the failure reason in its detail.

Export follows the chrome-trace conventions (pid per origin with its
rank, tid = slot lane), so serving timelines open in Perfetto; the
format is the JAX package's, byte for byte on the same timelines.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

# span phase vocabulary — mirrors the Request lifecycle states
QUEUED = "QUEUED"
PREFILL = "PREFILL"
DECODE = "DECODE"
PREEMPTED = "PREEMPTED"
MIGRATING = "MIGRATING"
FINISHED = "FINISHED"
FAILED = "FAILED"

TERMINAL = (FINISHED, FAILED)
PHASES = (QUEUED, PREFILL, DECODE, PREEMPTED, MIGRATING,
          FINISHED, FAILED)

#: ts/dur rounding (decimal places of a microsecond) for export —
#: fixed so the same virtual-clock replay emits the same bytes
_US_DP = 3


# -- span log primitives -----------------------------------------------------


def close_open(spans: List[dict], t_ms: float) -> Optional[dict]:
    """Close the trailing open span (``t1_ms is None``) at ``t_ms``.
    Returns the closed span, or None when nothing was open. A clock
    that did not advance closes a zero-length span; time never runs
    backwards within a timeline (clamped to the span's own start)."""
    if spans and spans[-1].get("t1_ms") is None:
        sp = spans[-1]
        sp["t1_ms"] = max(float(t_ms), sp["t0_ms"])
        return sp
    return None


def open_span(spans: List[dict], phase: str, t_ms: float, origin: str,
              slot: Optional[int] = None, **detail) -> dict:
    """Append a new OPEN span at ``t_ms``, closing any prior open span
    at the same instant — contiguity is structural, not checked after
    the fact."""
    closed = close_open(spans, t_ms)
    t0 = float(t_ms)
    if closed is not None:
        t0 = closed["t1_ms"]
    sp: dict = {"phase": phase, "t0_ms": t0, "t1_ms": None,
                "origin": str(origin)}
    if slot is not None:
        sp["slot"] = int(slot)
    if detail:
        sp["detail"] = {k: v for k, v in detail.items() if v is not None}
    spans.append(sp)
    return sp


def seal(spans: List[dict], phase: str, t_ms: float, origin: str,
         reason: Optional[str] = None) -> None:
    """Terminate a timeline: close the open span at ``t_ms`` and
    append the zero-length FINISHED/FAILED marker (with the failure
    reason in its detail). Idempotent — a timeline that already ends
    terminal is left alone, so a driver-level output path can seal
    defensively after an engine-level retire already did."""
    if spans and spans[-1].get("phase") in TERMINAL \
            and spans[-1].get("t1_ms") is not None:
        return
    closed = close_open(spans, t_ms)
    t = closed["t1_ms"] if closed is not None else float(t_ms)
    sp: dict = {"phase": phase, "t0_ms": t, "t1_ms": t,
                "origin": str(origin)}
    if reason:
        sp["detail"] = {"reason": str(reason)}
    spans.append(sp)


def bump_open(spans: List[dict], phase: str, **counts) -> None:
    """Accumulate numeric detail onto the trailing OPEN span when its
    phase matches — the multi-tick decode path stamps each fused
    dispatch's tick count onto the request's single tick-aggregated
    DECODE stint (spans stay O(lifecycle transitions), not
    O(dispatches)). No-op when nothing matching is open (a harvest
    that just sealed the span, a restore mid-stretch)."""
    if not spans or spans[-1].get("t1_ms") is not None \
            or spans[-1].get("phase") != phase:
        return
    det = spans[-1].setdefault("detail", {})
    for k, v in counts.items():
        det[k] = det.get(k, 0) + v


def current_phase(spans: List[dict]) -> Optional[str]:
    """Phase of the trailing OPEN span (None when nothing is open)."""
    if spans and spans[-1].get("t1_ms") is None:
        return spans[-1]["phase"]
    return None


def copy_spans(spans: List[dict]) -> List[dict]:
    """JSON-safe deep copy (snapshot serialization / Output attach —
    the live Request keeps mutating its own list)."""
    out = []
    for sp in spans:
        c = dict(sp)
        if "detail" in c:
            c["detail"] = dict(c["detail"])
        out.append(c)
    return out


def shift_spans(spans: List[dict], delta_ms: float) -> List[dict]:
    """Translate a timeline by ``delta_ms`` in place (restore onto a
    new clock epoch: durations and contiguity are preserved, absolute
    times re-anchor to the restoring process's clock)."""
    if delta_ms:
        for sp in spans:
            sp["t0_ms"] += delta_ms
            if sp.get("t1_ms") is not None:
                sp["t1_ms"] += delta_ms
    return spans


def restore_spans(spans: Optional[List[dict]], arrival_ms: float,
                  now_ms: float, origin: str,
                  resumed: bool) -> List[dict]:
    """Rebuild a snapshotted timeline on the restoring process's
    clock: shift so the timeline starts at the restored arrival time
    (durations and contiguity preserved; an in-process replay restore
    shifts by zero, keeping byte-identical timelines), close the span
    left open at snapshot time, and open the restored wait — PREEMPTED
    for a has-progress resume, QUEUED for an untouched request. A
    legacy entry with no spans starts a fresh QUEUED timeline."""
    spans = copy_spans(spans or [])
    if not spans:
        open_span(spans, QUEUED, now_ms, origin, kind="restore")
        return spans
    shift_spans(spans, arrival_ms - spans[0]["t0_ms"])
    open_span(spans, PREEMPTED if resumed else QUEUED, now_ms, origin,
              kind="restore")
    return spans


# -- validation --------------------------------------------------------------


def validate_timeline(spans: List[dict], tol_ms: float = 0.0
                      ) -> List[str]:
    """Check one request's span log against the timeline contract.
    Returns a list of human-readable problems — empty means the
    timeline is complete and contiguous. ``tol_ms`` loosens the
    contiguity equality for timelines reconstructed from a rounded
    export (0.0 for live span logs — the same floats propagate)."""
    problems: List[str] = []
    if not spans:
        return ["empty timeline"]
    if spans[0].get("phase") != QUEUED:
        problems.append(
            f"timeline starts {spans[0].get('phase')!r}, not QUEUED")
    last = spans[-1]
    if last.get("phase") not in TERMINAL:
        problems.append(
            f"no terminal span (ends {last.get('phase')!r})")
    elif last.get("phase") == FAILED and \
            not (last.get("detail") or {}).get("reason"):
        problems.append("FAILED terminal span carries no reason")
    prev_end = spans[0].get("t0_ms", 0.0)
    for k, sp in enumerate(spans):
        phase = sp.get("phase")
        if phase not in PHASES:
            problems.append(f"span {k}: unknown phase {phase!r}")
        t0, t1 = sp.get("t0_ms"), sp.get("t1_ms")
        if t1 is None:
            problems.append(f"span {k} ({phase}) left open")
            t1 = t0
        elif t1 < t0:
            problems.append(
                f"span {k} ({phase}) runs backwards ({t0}..{t1})")
        if abs(t0 - prev_end) > tol_ms:
            kind = "gap" if t0 > prev_end else "overlap"
            problems.append(
                f"span {k} ({phase}) {kind}: starts {t0}, previous "
                f"span ended {prev_end}")
        if phase in TERMINAL and k != len(spans) - 1:
            problems.append(
                f"span {k} ({phase}) is terminal but not last")
        prev_end = t1
    return problems


def phase_shares(spans: List[dict]) -> Dict[str, float]:
    """Total time (ms) per phase over one timeline — the per-request
    'where did the time go' summary the trace-summary tool tabulates
    fleet-wide."""
    out: Dict[str, float] = {}
    for sp in spans:
        t1 = sp.get("t1_ms")
        if t1 is None:
            continue
        dur = t1 - sp["t0_ms"]
        out[sp["phase"]] = out.get(sp["phase"], 0.0) + dur
    return out


# -- chrome-trace export -----------------------------------------------------


def build_serving_trace(timelines: Dict[int, List[dict]]) -> dict:
    """Chrome-trace dict for a set of stitched request timelines
    (``{req_id: spans}``): one pid per origin (replica/worker) carrying
    the process's rank (``profiler.chrome_trace._rank_info``), tid = slot lane
    (lane 0 is the queued/parked/migrating lane — spans with no slot),
    "X" complete events in microseconds off a common origin. Output is
    deterministic: origins, requests, and events are emitted in sorted
    order, times rounded to fixed precision — the same virtual-clock
    replay produces byte-identical bytes."""
    from ..profiler.chrome_trace import _rank_info
    rank, world = _rank_info()

    origins: List[str] = sorted(
        {sp["origin"] for spans in timelines.values() for sp in spans})
    pid_of = {o: i for i, o in enumerate(origins)}
    starts = [sp["t0_ms"] for spans in timelines.values()
              for sp in spans]
    t0 = min(starts) if starts else 0.0

    def us(t_ms: float) -> float:
        return round((t_ms - t0) * 1e3, _US_DP)

    events: List[dict] = []
    lanes = set()
    xevents: List[dict] = []
    for rid in sorted(timelines):
        for seq, sp in enumerate(timelines[rid]):
            t1 = sp.get("t1_ms")
            if t1 is None:       # defensive: export never drops a span
                t1 = sp["t0_ms"]
            pid = pid_of[sp["origin"]]
            lane = sp.get("slot")
            tid = 0 if lane is None else int(lane) + 1
            lanes.add((pid, tid))
            # seq preserves timeline order through the global event
            # sort (zero-length spans share one ts within a tick)
            args = {"req": int(rid), "seq": seq}
            args.update(sp.get("detail") or {})
            xevents.append({
                "ph": "X", "cat": "span", "name": sp["phase"],
                "pid": pid, "tid": tid, "ts": us(sp["t0_ms"]),
                "dur": round((t1 - sp["t0_ms"]) * 1e3, _US_DP),
                "args": args})
    for o in origins:
        pid = pid_of[o]
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": f"{o} (serving)"}})
        events.append({"ph": "M", "name": "process_sort_index",
                       "pid": pid, "tid": 0,
                       "args": {"sort_index": pid}})
    for pid, tid in sorted(lanes):
        name = "queue" if tid == 0 else f"slot {tid - 1}"
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    xevents.sort(key=lambda e: (e["ts"], e["args"]["req"],
                                e["args"]["seq"]))
    events.extend(xevents)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {"tool": "paddle_tpu.serving_timeline",
                         "rank": rank, "world_size": world,
                         "requests": len(timelines)}}


def export_serving_trace(timelines: Dict[int, List[dict]],
                         path: str) -> str:
    """Write the stitched timelines as chrome-trace JSON. sort_keys +
    fixed separators: the byte stream is a pure function of the
    timelines, so two replays of one seed diff empty."""
    trace = build_serving_trace(timelines)
    with open(path, "w") as f:
        json.dump(trace, f, sort_keys=True, separators=(",", ":"))
    return path


def timelines_from_trace(trace: dict) -> Dict[int, List[dict]]:
    """Inverse of ``build_serving_trace`` (modulo ts rounding): the
    per-request span logs reconstructed from an export, for round-trip
    tests and the completeness gate's assert-via-the-artifact check.
    Validate reconstructed timelines with a small ``tol_ms`` — export
    rounds to 1e-3 us."""
    names = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            label = str(ev.get("args", {}).get("name", ev["pid"]))
            if label.endswith(" (serving)"):
                label = label[:-len(" (serving)")]
            names[ev["pid"]] = label
    out: Dict[int, List[dict]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") != "span":
            continue
        rid = int(ev.get("args", {}).get("req", -1))
        seq = int(ev.get("args", {}).get("seq", 0))
        t0 = float(ev["ts"]) / 1e3
        sp = {"phase": ev["name"], "t0_ms": t0,
              "t1_ms": t0 + float(ev.get("dur", 0.0)) / 1e3,
              "origin": names.get(ev["pid"], str(ev["pid"])),
              "_seq": seq}
        if ev.get("tid", 0) > 0:
            sp["slot"] = int(ev["tid"]) - 1
        detail = {k: v for k, v in ev.get("args", {}).items()
                  if k not in ("req", "seq")}
        if detail:
            sp["detail"] = detail
        out.setdefault(rid, []).append(sp)
    for spans in out.values():
        spans.sort(key=lambda s: s.pop("_seq"))
    return out
