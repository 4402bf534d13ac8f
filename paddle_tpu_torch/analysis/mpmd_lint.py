"""mpmd_lint: the device-free model checker over MPMD pipeline event
graphs (counterpart of ``paddle_tpu/analysis/mpmd_lint.py``, a copy:
pure Python over the graph).

``distributed.mpmd_graph`` writes each schedule out as per-stage event
programs with explicit send/recv declarations, bounded buffers and
declared dataflow deps. This pass checks a graph without devices:

* ``mpmd.deadlock``          — a cycle in the happens-before relation
  (per-stage program order + matched comm edges + bounded-channel
  back-edges: the i-th send on a capacity-C route cannot run before
  the (i-C)-th recv has drained its slot).
* ``mpmd.unmatched-p2p``     — FIFO matching per route: the i-th send
  must pair with the i-th recv, tag/shape/dtype exact; orphans and
  order flips are the findings.
* ``mpmd.buffer-race``       — write-before-read-complete on a reused
  activation/grad slot (or a read of a never-written slot), walked in
  stage program order.
* ``mpmd.hbm-over-budget``   — per-stage in-flight buffer high-water
  (occupied slots x slot bytes) against a memory budget.
* ``mpmd.dataflow-mismatch`` — the tick order must topologically
  linearize the declared microbatch dataflow DAG (every dep lands
  strictly earlier; every matched hop arrives a tick before its
  consumer), and the graph's tick/bubble accounting must agree with
  ``pipeline.schedule_stats``.
* ``mpmd.stale-weight``      — a W-phase weight write scheduled before
  a same-(stage, chunk) fwd still consuming the pre-update version.

``distributed.mpmd_runtime.MpmdDriver`` refuses a graph with findings.
Rule ids are ``mpmd.``-prefixed; ``emit_mpmd`` counts them as
``lint.mpmd.*`` monitor counters.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .findings import (ERROR, MPMD_BUFFER_RACE, MPMD_DATAFLOW_MISMATCH,
                       MPMD_DEADLOCK, MPMD_HBM_OVER_BUDGET, MPMD_RULES,
                       MPMD_STALE_WEIGHT, MPMD_UNMATCHED_P2P, Finding,
                       Report)


def _find(g, rule: str, message: str, suggestion: str = "") -> Finding:
    return Finding(rule=rule, severity=ERROR, message=message,
                   file=g.file, line=g.line, suggestion=suggestion)


# -- p2p matching ------------------------------------------------------------

def _match_p2p(g, report: Report):
    """FIFO matching per route; returns the matched (send_idx, recv_idx)
    comm pairs as event-index edges, plus per-route send/recv event
    lists for the capacity back-edges."""
    order: Dict[Tuple[int, int, str, int], int] = {}
    events = []
    for ev in g.events():
        order[ev.key] = len(events)
        events.append(ev)
    sends: Dict[Tuple[int, int], List[Tuple[int, object]]] = {}
    recvs: Dict[Tuple[int, int], List[Tuple[int, object]]] = {}
    for i, ev in enumerate(events):
        for msg in ev.sends:
            sends.setdefault((ev.stage, msg.peer), []).append((i, msg))
        for msg in ev.recvs:
            recvs.setdefault((msg.peer, ev.stage), []).append((i, msg))
    comm_edges: List[Tuple[int, int]] = []
    route_pairs: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for route in sorted(set(sends) | set(recvs)):
        ss, rr = sends.get(route, []), recvs.get(route, [])
        bad = None
        for i in range(min(len(ss), len(rr))):
            (si, sm), (ri, rm) = ss[i], rr[i]
            if sm.tag != rm.tag or sm.shape != rm.shape \
                    or sm.dtype != rm.dtype:
                bad = (f"message {i} on route {route[0]}->{route[1]} "
                       f"pairs send {sm.tag}/{sm.shape}/{sm.dtype} "
                       f"({events[si].describe()}) with recv "
                       f"{rm.tag}/{rm.shape}/{rm.dtype} "
                       f"({events[ri].describe()}) — the FIFO channel "
                       f"delivers the wrong payload")
                break
            comm_edges.append((si, ri))
            route_pairs.setdefault(route, []).append((si, ri))
        if bad is None and len(ss) != len(rr):
            kind = "send" if len(ss) > len(rr) else "recv"
            extra = abs(len(ss) - len(rr))
            ev = events[(ss if len(ss) > len(rr) else rr)[-1][0]]
            bad = (f"route {route[0]}->{route[1]} has {extra} orphan "
                   f"{kind}(s) (last: {ev.describe()}) — every send "
                   f"needs exactly one ordered matching recv")
        if bad is not None:
            report.add(_find(
                g, MPMD_UNMATCHED_P2P, bad,
                suggestion="align the send/recv schedules per route "
                           "(same count, same order, exact "
                           "shape/dtype)"))
    return events, order, comm_edges, route_pairs, sends, recvs


# -- happens-before + deadlock -----------------------------------------------

def _happens_before(g, events, comm_edges, route_pairs):
    """Edge list (a, b, strong). Strong edges are strictly-before
    (per-stage program order; a matched message must be sent before it
    is received). Channel-capacity back-edges — send i cannot deposit
    until recv i-cap drained its slot — are WEAK (before-or-
    simultaneous): the lockstep ppermute drains and refills a route's
    register in the same tick, one atomic rotate, so a pure back-edge
    cycle is exactly that simultaneous exchange, not a hazard."""
    edges: List[Tuple[int, int, bool]] = []
    idx = 0
    # event order in events is per-stage program order (g.events()),
    # so stage programs occupy contiguous index ranges
    for s in range(g.n_stages):
        prog = g.programs.get(s, ())
        for k in range(len(prog) - 1):
            edges.append((idx + k, idx + k + 1, True))
        idx += len(prog)
    for a, b in comm_edges:
        edges.append((a, b, True))
    cap_default = g.DEFAULT_CHANNEL_CAPACITY
    for route, pairs in route_pairs.items():
        cap = g.channel_capacity.get(route, cap_default)
        for i in range(cap, len(pairs)):
            edges.append((pairs[i - cap][1], pairs[i][0], False))
    return edges


def _sccs(n, edges) -> List[int]:
    """Iterative Tarjan; returns the SCC id per node."""
    adj: List[List[int]] = [[] for _ in range(n)]
    for a, b, _ in edges:
        adj[a].append(b)
    index = [0] * n
    low = [0] * n
    on = [False] * n
    comp = [-1] * n
    stack: List[int] = []
    counter = [1]
    ncomp = [0]
    for root in range(n):
        if index[root]:
            continue
        work = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on[node] = True
            recurse = False
            for j in range(pi, len(adj[node])):
                nxt = adj[node][j]
                if index[nxt] == 0:
                    work[-1] = (node, j + 1)
                    work.append((nxt, 0))
                    recurse = True
                    break
                if on[nxt]:
                    low[node] = min(low[node], index[nxt])
            if recurse:
                continue
            if low[node] == index[node]:
                while True:
                    w = stack.pop()
                    on[w] = False
                    comp[w] = ncomp[0]
                    if w == node:
                        break
                ncomp[0] += 1
            work.pop()
            if work:
                p = work[-1][0]
                low[p] = min(low[p], low[node])
    return comp


def _find_deadlock(n, edges) -> Optional[List[int]]:
    """A strong (strictly-before) edge inside an SCC lies on a cycle
    that no execution order can satisfy — deadlock. Returns a witness
    cycle, or None. Pure-weak SCCs (simultaneous lockstep exchanges)
    are realizable and ignored."""
    comp = _sccs(n, edges)
    strong = None
    for a, b, is_strong in edges:
        if is_strong and comp[a] == comp[b]:
            strong = (a, b)
            break
    if strong is None:
        return None
    a, b = strong
    # witness: shortest path b -> a inside the SCC, closed by a -> b
    adj: List[List[int]] = [[] for _ in range(n)]
    for u, v, _ in edges:
        if comp[u] == comp[a] and comp[v] == comp[a]:
            adj[u].append(v)
    prev = {b: None}
    frontier = [b]
    while frontier and a not in prev:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if v not in prev:
                    prev[v] = u
                    nxt.append(v)
        frontier = nxt
    path = [a]
    while path[-1] != b and path[-1] in prev and prev[path[-1]] is not None:
        path.append(prev[path[-1]])
    path.reverse()              # b ... a
    return [a] + path[:-1] if len(path) > 1 else [a, b]


# -- buffers: races + high-water ---------------------------------------------

def _check_buffers(g, report: Report, hbm_budget: Optional[float]):
    worst = (0, None)   # (high_water_bytes, stage)
    for s in range(g.n_stages):
        pending: Dict[Tuple[str, int], int] = {}
        flagged = set()
        occupancy = 0
        high = 0
        for ev in g.programs.get(s, ()):
            for buf, slot in ev.reads:
                spec = g.buffers.get((s, buf))
                if pending.get((buf, slot), 0) > 0:
                    pending[(buf, slot)] -= 1
                    occupancy -= spec.slot_bytes if spec else 0
                elif buf not in flagged:
                    flagged.add(buf)
                    report.add(_find(
                        g, MPMD_BUFFER_RACE,
                        f"stage {s}: {ev.describe()} reads "
                        f"{buf}[{slot}] before any unconsumed write — "
                        f"the slot's value was never produced (or was "
                        f"already drained)",
                        suggestion="re-order the schedule so every "
                                   "read follows its producing write"))
            for buf, slot in ev.writes:
                spec = g.buffers.get((s, buf))
                if pending.get((buf, slot), 0) > 0 \
                        and buf not in flagged:
                    flagged.add(buf)
                    report.add(_find(
                        g, MPMD_BUFFER_RACE,
                        f"stage {s}: {ev.describe()} overwrites "
                        f"{buf}[{slot}] while a previous value is "
                        f"still unread — write-before-read-complete "
                        f"on a reused slot",
                        suggestion="give the buffer more slots or "
                                   "delay the write until the reader "
                                   "drains the slot"))
                pending[(buf, slot)] = pending.get((buf, slot), 0) + 1
                occupancy += spec.slot_bytes if spec else 0
                high = max(high, occupancy)
        if high > worst[0]:
            worst = (high, s)
    if hbm_budget is not None and worst[1] is not None \
            and worst[0] > hbm_budget:
        report.add(_find(
            g, MPMD_HBM_OVER_BUDGET,
            f"stage {worst[1]}: in-flight buffer high-water "
            f"{worst[0]} bytes exceeds the {int(hbm_budget)}-byte HBM "
            f"budget — the schedule holds too many live slots at once",
            suggestion="raise n_micro granularity, drop buffer slots, "
                       "or pick a schedule with a shorter slot "
                       "lifetime (ZBH1 drains W early)"))
    return worst[0]


# -- stale weights -----------------------------------------------------------

def _check_stale_weights(g, report: Report):
    for s in range(g.n_stages):
        w_seen = set()
        flagged = set()
        for ev in g.programs.get(s, ()):
            if ev.phase == "w":
                w_seen.add(ev.chunk)
            elif ev.phase == "fwd" and ev.chunk in w_seen \
                    and ev.chunk not in flagged:
                flagged.add(ev.chunk)
                report.add(_find(
                    g, MPMD_STALE_WEIGHT,
                    f"stage {s}: {ev.describe()} consumes chunk "
                    f"{ev.chunk} weights AFTER a W-phase write of the "
                    f"same version — the reordered update poisons the "
                    f"remaining forwards of this step",
                    suggestion="keep every W event after the last fwd "
                               "of its (stage, chunk) within the step"))


# -- dataflow linearization + bubble accounting ------------------------------

def _exec_index(g):
    """(tick, stage-local position) per event key — the lockstep
    execution order the compiled scan realizes."""
    out = {}
    for s in range(g.n_stages):
        for k, ev in enumerate(g.programs.get(s, ())):
            out[ev.key] = (ev.tick, s, k)
    return out

def _check_dataflow(g, report: Report, events, route_pairs):
    ix = _exec_index(g)
    key_ev = {ev.key: ev for ev in events}
    bad_deps = 0
    first = None
    for a, b in g.deps:
        if a not in ix or b not in ix:
            report.add(_find(
                g, MPMD_DATAFLOW_MISMATCH,
                f"dataflow dep references a missing event: "
                f"{a if a not in ix else b} — the schedule never "
                f"executes it",
                suggestion="emit every (stage, micro, phase) the "
                           "dataflow DAG requires"))
            return
        ta, tb = ix[a][0], ix[b][0]
        same_stage = a[0] == b[0]
        ok = ta < tb or (same_stage and ta == tb
                         and ix[a][2] < ix[b][2])
        if not ok:
            bad_deps += 1
            if first is None:
                first = (key_ev[a], key_ev[b])
    if bad_deps:
        a, b = first
        report.add(_find(
            g, MPMD_DATAFLOW_MISMATCH,
            f"execution order is not a topological linearization of "
            f"the dataflow DAG: {b.describe()} runs at/before its "
            f"dependency {a.describe()} ({bad_deps} violated dep(s)) "
            f"— token/grad exactness is lost",
            suggestion="re-derive the tick equations; every consumer "
                       "must tick strictly after its producer"))
        return
    # one-hop-per-tick feasibility of every matched message
    for route, pairs in route_pairs.items():
        for si, ri in pairs:
            if events[ri].tick < events[si].tick + 1:
                report.add(_find(
                    g, MPMD_DATAFLOW_MISMATCH,
                    f"message {events[si].describe()} -> "
                    f"{events[ri].describe()} on route "
                    f"{route[0]}->{route[1]} arrives the tick it is "
                    f"sent — the lockstep ring delivers one hop per "
                    f"tick",
                    suggestion="delay the consumer a tick (the "
                               "schedule is one tick too tight)"))
                return
    # bubble accounting vs pipeline.schedule_stats
    stats = g.meta.get("stats")
    if not stats or g.n_stages <= 1:
        return
    fwd_ticks = [ev.tick for ev in events if ev.phase == "fwd"]
    span = max(fwd_ticks) - min(fwd_ticks) + 1 if fwd_ticks else 0
    want_units = g.n_micro * g.vpp_degree
    per_stage = [sum(1 for ev in g.programs.get(s, ())
                     if ev.phase == "fwd")
                 for s in range(g.n_stages)]
    if span != stats["ticks"] or any(c != want_units
                                     for c in per_stage):
        report.add(_find(
            g, MPMD_DATAFLOW_MISMATCH,
            f"bubble accounting disagrees with schedule_stats"
            f"({g.schedule_mode}, S={g.n_stages}, M={g.n_micro}, "
            f"V={g.vpp_degree}): graph fwd span {span} ticks / "
            f"per-stage units {per_stage}, stats expect "
            f"{stats['ticks']} ticks / {want_units} units per stage",
            suggestion="the event graph and the compiled schedule "
                       "have drifted — re-derive the graph's construction from "
                       "the scan body"))


# -- entry points ------------------------------------------------------------

def check_graph(graph, *, hbm_budget: Optional[float] = None,
                subject: Optional[str] = None) -> Report:
    """Run every mpmd.* rule over one event graph."""
    report = Report(subject=subject or graph.subject)
    events, order, comm_edges, route_pairs, sends, recvs = \
        _match_p2p(graph, report)
    edges = _happens_before(graph, events, comm_edges, route_pairs)
    cycle = _find_deadlock(len(events), edges)
    if cycle is not None:
        path = " -> ".join(events[i].describe() for i in cycle[:8])
        report.add(_find(
            graph, MPMD_DEADLOCK,
            f"happens-before cycle (schedule cannot make progress): "
            f"{path} -> {events[cycle[0]].describe()} — a blocked "
            f"send/recv waits on work that waits on it",
            suggestion="raise the route's channel capacity or re-order "
                       "the consumer so the bounded slot drains first"))
    _check_buffers(graph, report, hbm_budget)
    _check_stale_weights(graph, report)
    if cycle is None:
        _check_dataflow(graph, report, events, route_pairs)
    return report


def lint_mpmd(obj=None, *, spec=None, n_stages: Optional[int] = None,
              n_micro: Optional[int] = None,
              schedule_mode: Optional[str] = None,
              vpp_degree: Optional[int] = None,
              act_shape: Optional[Tuple[int, ...]] = None,
              hbm_budget: Optional[float] = None,
              subject: Optional[str] = None) -> Report:
    """Model-check a schedule or plan device-free.

    ``obj`` may be an ``MpmdGraph``, a planner ``Plan`` (with ``spec``
    for the proxy-trace dims), a ``PipelineLayer``/``PipelineParallel``
    (same resolution as ``lint_pipeline``), or ``None`` with explicit
    ``schedule_mode``/``n_stages``/``n_micro``/``vpp_degree`` kwargs."""
    from ..distributed import mpmd_graph as mg
    if obj is None:
        if n_stages is None or n_micro is None:
            raise ValueError("lint_mpmd() needs a graph/plan/pipeline "
                             "or explicit n_stages + n_micro")
        g = mg.schedule_graph(schedule_mode or "FThenB", n_stages,
                              n_micro, vpp_degree or 1,
                              act_shape=act_shape or (4, 16))
    elif isinstance(obj, mg.MpmdGraph):
        g = obj
    elif hasattr(obj, "degrees") and hasattr(obj, "schedule_mode"):
        g = mg.plan_graph(spec, obj)        # raises: the planner
    else:
        g = mg.pipeline_graph(obj, n_micro=n_micro,
                              schedule_mode=schedule_mode,
                              vpp_degree=vpp_degree,
                              act_shape=act_shape)
    return check_graph(g, hbm_budget=hbm_budget, subject=subject)


def emit_mpmd(report: Report) -> Report:
    """Count a lint_mpmd() report in the monitor: ``lint.mpmd.checks``
    once, and ``lint.mpmd.<rule>`` for each finding; a non-empty report
    warns once with its findings."""
    import warnings

    from .. import monitor
    monitor.counter("lint.mpmd.checks").increase()
    for f in report:
        monitor.counter(f"lint.{f.rule}").increase()
    if report:
        warnings.warn(report.format(), stacklevel=2)
    return report


__all__ = ["MPMD_RULES", "check_graph", "emit_mpmd", "lint_mpmd"]
