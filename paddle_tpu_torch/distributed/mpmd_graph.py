"""mpmd_graph: explicit MPMD event graphs of the pipeline schedules
(counterpart of ``paddle_tpu/distributed/mpmd_graph.py``, a copy: the
module is pure Python over integers).

Each schedule (FThenB / VPP in ``distributed/pipeline.py``, ZBH1 / ZBVPP
in ``distributed/zero_bubble.py``) is written out as:

* per-(stage, microbatch, phase in {fwd, bwd, w}) compute **events**,
  in each stage's local execution order, stamped with the lockstep tick
  they run at;
* explicit **send/recv declarations** on events, shape/dtype-exact, with
  FIFO routes and per-route channel capacities (the inter-round wrap of
  VPP / ZBVPP is a route of capacity M-S+1);
* per-stage bounded **buffer slots** (activation stashes, ZB weight-grad
  frontiers) with the events that write and read each slot;
* declared **dataflow deps**, the chain-rule DAG the execution order
  must topologically linearize;
* per-stage **program descriptors**.

In the port these graphs are not only checked: each pp rank's runtime
(``pipeline.StageRunner``) executes its stage's program of the graph,
event by event, its p2p messages posted at the ticks the graph gives, and
the one-process ``mpmd_runtime.MpmdDriver`` executes all stages. So the
runtime, the graph and ``analysis.mpmd_lint`` cannot drift apart.

Divergences from the JAX module:

* ``schedule_graph("1F1B", ...)`` is a real one-forward-one-backward
  order (``one_f_one_b_graph``): stage s runs min(S-s-1, M) warm-up
  forwards, then alternates, so it holds at most S-s live activations
  (its ``acts`` buffer has that many slots). The JAX package compiles
  1F1B as FThenB and returns the GPipe graph;
* ``file`` / ``line`` point into the port's schedule code;
* ``plan_graph`` waits for the planner (the analysis item of the
  roadmap), ``ring_graph`` for sequence parallelism (D3) and
  ``disagg_graph`` for disaggregated serving (D5): each raises naming
  it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

FWD, BWD, W = "fwd", "bwd", "w"
_PHASES = (FWD, BWD, W)

# EventKey: (stage, micro, phase, chunk) — unique per graph
EventKey = Tuple[int, int, str, int]


@dataclasses.dataclass(frozen=True)
class Msg:
    """One declared send or recv on an event: the peer stage, a FIFO
    matching tag (phase, microbatch, chunk — what the payload IS), and
    the exact wire shape/dtype."""
    peer: int
    tag: Tuple
    shape: Tuple[int, ...]
    dtype: str


@dataclasses.dataclass
class Event:
    """One compute event of the schedule. ``tick`` is the lockstep tick
    the compiled scan runs it at (the execution order mpmd_lint checks
    against the dataflow DAG); ``sends``/``recvs`` are its declared
    p2p endpoints; ``reads``/``writes`` its (buffer, slot) accesses."""
    stage: int
    micro: int
    phase: str
    chunk: int = 0
    tick: int = 0
    sends: List[Msg] = dataclasses.field(default_factory=list)
    recvs: List[Msg] = dataclasses.field(default_factory=list)
    reads: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    writes: List[Tuple[str, int]] = dataclasses.field(default_factory=list)

    @property
    def key(self) -> EventKey:
        return (self.stage, self.micro, self.phase, self.chunk)

    def describe(self) -> str:
        c = f",c{self.chunk}" if self.chunk else ""
        return f"{self.phase}[s{self.stage},m{self.micro}{c}]@t{self.tick}"


@dataclasses.dataclass
class BufferSpec:
    """A bounded per-stage buffer: ``slots`` concurrent values of
    ``slot_bytes`` each (an activation stash, a ZB weight-grad
    frontier, a wrap register)."""
    name: str
    stage: int
    slots: int
    slot_bytes: int = 0


class MpmdGraph:
    """The event graph: per-stage ordered programs + routes + buffers +
    declared dataflow deps. ``to_dict()`` is the serialized form a
    future MPMD driver consumes; ``analysis.mpmd_lint.check_graph``
    is its static verifier."""

    def __init__(self, n_stages: int, *, schedule_mode: str = "",
                 n_micro: int = 1, vpp_degree: int = 1,
                 act_shape: Tuple[int, ...] = (),
                 act_dtype: str = "float32",
                 subject: str = "", file: str = "<mpmd>", line: int = 0):
        self.n_stages = int(n_stages)
        self.schedule_mode = schedule_mode
        self.n_micro = int(n_micro)
        self.vpp_degree = max(1, int(vpp_degree))
        self.act_shape = tuple(act_shape)
        self.act_dtype = act_dtype
        self.subject = subject or (
            f"mpmd({schedule_mode or 'graph'}, S={n_stages}, "
            f"M={n_micro}" + (f", V={vpp_degree}" if vpp_degree > 1
                              else "") + ")")
        self.file, self.line = file, line
        # stage -> events in local execution order
        self.programs: Dict[int, List[Event]] = {
            s: [] for s in range(self.n_stages)}
        self.buffers: Dict[Tuple[int, str], BufferSpec] = {}
        # (src_stage, dst_stage) -> in-flight message bound; a route not
        # listed here gets DEFAULT_CHANNEL_CAPACITY
        self.channel_capacity: Dict[Tuple[int, int], int] = {}
        # required dataflow edges (chain rule): a must complete before b
        self.deps: List[Tuple[EventKey, EventKey]] = []
        # per-stage program descriptors (what the stage RUNS)
        self.descriptors: Dict[int, Dict[str, object]] = {}
        # expected schedule_stats for the bubble cross-check (standard
        # modes only; hand-built / ring / disagg graphs leave it None)
        self.meta: Dict[str, object] = {}

    DEFAULT_CHANNEL_CAPACITY = 1   # lockstep ppermute: one hop in flight

    # -- construction --------------------------------------------------------

    def add_event(self, stage: int, micro: int, phase: str, *,
                  chunk: int = 0, tick: int = 0) -> Event:
        ev = Event(stage=stage, micro=micro, phase=phase, chunk=chunk,
                   tick=tick)
        self.programs.setdefault(stage, []).append(ev)
        return ev

    def add_buffer(self, stage: int, name: str, slots: int,
                   slot_bytes: int = 0) -> BufferSpec:
        buf = BufferSpec(name=name, stage=stage, slots=slots,
                         slot_bytes=slot_bytes)
        self.buffers[(stage, name)] = buf
        return buf

    def add_dep(self, a: EventKey, b: EventKey) -> None:
        self.deps.append((a, b))

    def connect(self, src: Event, dst: Event,
                shape: Optional[Tuple[int, ...]] = None,
                dtype: Optional[str] = None,
                tag: Optional[Tuple] = None) -> None:
        """Declare a matched send/recv pair src -> dst (same tag both
        ends) AND the dataflow dep it implements."""
        shape = self.act_shape if shape is None else tuple(shape)
        dtype = self.act_dtype if dtype is None else dtype
        tag = tag if tag is not None else (src.phase, src.micro, src.chunk)
        src.sends.append(Msg(peer=dst.stage, tag=tag, shape=shape,
                             dtype=dtype))
        dst.recvs.append(Msg(peer=src.stage, tag=tag, shape=shape,
                             dtype=dtype))
        self.add_dep(src.key, dst.key)

    # -- views ---------------------------------------------------------------

    def events(self) -> Iterator[Event]:
        for s in range(self.n_stages):
            yield from self.programs.get(s, ())

    def event_index(self) -> Dict[EventKey, Event]:
        return {ev.key: ev for ev in self.events()}

    def n_events(self) -> int:
        return sum(len(p) for p in self.programs.values())

    def stage_descriptor(self, stage: int) -> Dict[str, object]:
        base = {"stage": stage,
                "events": len(self.programs.get(stage, ())),
                "act_shape": list(self.act_shape),
                "act_dtype": self.act_dtype}
        base.update(self.descriptors.get(stage, {}))
        return base

    def act_bytes(self) -> int:
        n = 1
        for d in self.act_shape:
            n *= int(d)
        return n * _dtype_bytes(self.act_dtype)

    def to_dict(self) -> Dict[str, object]:
        """MpmdDriver's input format: per-stage programs (ordered events
        with their comm/buffer accesses), routes, buffers, deps,
        descriptors. Everything an executor needs to run the schedule
        as explicit data movement between fixed per-stage programs."""
        return {
            "subject": self.subject,
            "schedule_mode": self.schedule_mode,
            "n_stages": self.n_stages,
            "n_micro": self.n_micro,
            "vpp_degree": self.vpp_degree,
            "act_shape": list(self.act_shape),
            "act_dtype": self.act_dtype,
            "stages": {
                s: {"descriptor": self.stage_descriptor(s),
                    "events": [{
                        "key": list(ev.key), "tick": ev.tick,
                        "sends": [dataclasses.asdict(m) for m in ev.sends],
                        "recvs": [dataclasses.asdict(m) for m in ev.recvs],
                        "reads": list(ev.reads), "writes": list(ev.writes),
                    } for ev in self.programs.get(s, ())]}
                for s in range(self.n_stages)},
            "buffers": [dataclasses.asdict(b)
                        for b in self.buffers.values()],
            "channel_capacity": {f"{a}->{b}": c for (a, b), c
                                 in self.channel_capacity.items()},
            "deps": [[list(a), list(b)] for a, b in self.deps],
        }

    # a descriptor's base keys are recomputed by stage_descriptor();
    # only the extras (stage_items / stage_layers / param_bytes / ...)
    # are stored on the graph and survive a round trip
    _DESC_BASE_KEYS = ("stage", "events", "act_shape", "act_dtype")

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "MpmdGraph":
        """Rebuild a graph from ``to_dict()`` output — including after a
        ``json.dumps``/``loads`` round trip (string stage keys, ``a->b``
        capacity keys, tuples flattened to lists). ``file``/``line`` are
        not serialized, so findings on a deserialized graph locate at
        ``<mpmd>:0``; the bubble cross-check stats are re-derived from
        ``pipeline.schedule_stats`` for standard modes, exactly as
        ``schedule_graph`` stamps them."""
        g = cls(int(d["n_stages"]),
                schedule_mode=str(d.get("schedule_mode", "") or ""),
                n_micro=int(d.get("n_micro", 1)),
                vpp_degree=int(d.get("vpp_degree", 1)),
                act_shape=tuple(int(x) for x in d.get("act_shape", ())),
                act_dtype=str(d.get("act_dtype", "float32")),
                subject=str(d.get("subject", "") or ""))

        def _key(k) -> EventKey:
            s, m, ph, c = k
            return (int(s), int(m), str(ph), int(c))

        def _msg(md) -> Msg:
            return Msg(peer=int(md["peer"]),
                       tag=tuple(md.get("tag", ())),
                       shape=tuple(int(x) for x in md.get("shape", ())),
                       dtype=str(md.get("dtype", "float32")))

        def _slots(pairs):
            return [(str(b), int(sl)) for b, sl in pairs]

        for s_key, stage_d in (d.get("stages") or {}).items():
            s = int(s_key)
            extras = {k: v
                      for k, v in (stage_d.get("descriptor") or {}).items()
                      if k not in cls._DESC_BASE_KEYS}
            if extras:
                g.descriptors[s] = extras
            for ev_d in stage_d.get("events", ()):
                es, em, eph, ec = _key(ev_d["key"])
                ev = g.add_event(es, em, eph, chunk=ec,
                                 tick=int(ev_d.get("tick", 0)))
                ev.sends = [_msg(m) for m in ev_d.get("sends", ())]
                ev.recvs = [_msg(m) for m in ev_d.get("recvs", ())]
                ev.reads = _slots(ev_d.get("reads", ()))
                ev.writes = _slots(ev_d.get("writes", ()))
        for b in d.get("buffers", ()):
            g.add_buffer(int(b["stage"]), str(b["name"]),
                         int(b["slots"]), int(b.get("slot_bytes", 0)))
        caps = d.get("channel_capacity") or {}
        for route, cap in caps.items():
            if isinstance(route, str):
                a, b = route.split("->")
            else:
                a, b = route
            g.channel_capacity[(int(a), int(b))] = int(cap)
        for a, b in d.get("deps", ()):
            g.add_dep(_key(a), _key(b))
        if g.n_stages > 1 and (g.schedule_mode or "").upper() in (
                "FTHENB", "VPP", "ZBH1", "ZBVPP"):
            from .pipeline import schedule_stats
            g.meta["stats"] = schedule_stats(
                g.schedule_mode, g.n_stages, g.n_micro, g.vpp_degree)
        return g

    def __repr__(self):
        return (f"MpmdGraph({self.subject!r}, events={self.n_events()}, "
                f"deps={len(self.deps)})")


def _dtype_bytes(dtype: str) -> int:
    d = str(dtype)
    for tail, n in (("64", 8), ("32", 4), ("16", 2), ("8", 1)):
        if d.endswith(tail):
            return n
    return 4


def _loc(fn) -> Tuple[str, int]:
    code = getattr(fn, "__code__", None)
    if code is None:
        return "<mpmd>", 0
    return code.co_filename, code.co_firstlineno


def _stage_descriptors(g: MpmdGraph, stage_layers: Optional[int] = None,
                       param_bytes: Optional[float] = None) -> None:
    for s in range(g.n_stages):
        d: Dict[str, object] = {}
        if stage_layers is not None:
            d["stage_layers"] = stage_layers
        if param_bytes is not None:
            d["param_bytes"] = param_bytes
        g.descriptors[s] = d


# ---------------------------------------------------------------------------
# standard-mode graphs — tick equations mirror the JAX scan bodies
# ---------------------------------------------------------------------------

def gpipe_graph(n_stages: int, n_micro: int, *,
                act_shape: Tuple[int, ...] = (4, 16),
                act_dtype: str = "float32",
                backward: bool = True,
                schedule_mode: str = "FThenB") -> MpmdGraph:
    """FThenB/GPipe (``pipeline.gpipe_local``): fwd(s, m) at tick s+m
    riding the forward ring; the autodiff backward reverses every edge,
    bwd(s, m) at tick T_f + (S-1-s) + m on the reverse ring. Each stage
    stashes its M microbatch inputs for the backward read."""
    from .pipeline import gpipe_local
    S, M = int(n_stages), int(n_micro)
    file, line = _loc(gpipe_local)
    g = MpmdGraph(S, schedule_mode=schedule_mode, n_micro=M,
                  act_shape=act_shape, act_dtype=act_dtype,
                  file=file, line=line)
    ab = g.act_bytes()
    T_f = M + S - 1
    for s in range(S):
        g.add_buffer(s, "acts", slots=M, slot_bytes=ab)
    ev_f: Dict[Tuple[int, int], Event] = {}
    for t in range(T_f):
        for s in range(S):
            m = t - s
            if 0 <= m < M:
                ev = g.add_event(s, m, FWD, tick=t)
                ev.writes.append(("acts", m))
                ev_f[(s, m)] = ev
                if s > 0:
                    g.connect(ev_f[(s - 1, m)], ev)
    if not backward:
        return g
    ev_b: Dict[Tuple[int, int], Event] = {}
    for t in range(T_f):
        for s in range(S):
            m = t - (S - 1 - s)
            if 0 <= m < M:
                ev = g.add_event(s, m, BWD, tick=T_f + t)
                ev.reads.append(("acts", m))
                g.add_dep(ev_f[(s, m)].key, ev.key)
                ev_b[(s, m)] = ev
        for s in range(S - 1, -1, -1):   # reverse ring: s+1 -> s
            m = t - (S - 1 - s)
            if 0 <= m < M and s < S - 1:
                g.connect(ev_b[(s + 1, m)], ev_b[(s, m)])
    return g


def one_f_one_b_graph(n_stages: int, n_micro: int, *,
                      act_shape: Tuple[int, ...] = (4, 16),
                      act_dtype: str = "float32") -> MpmdGraph:
    """1F1B (``pipeline.one_f_one_b_local``): stage s runs
    w = min(S-1-s, M) warm-up forwards, then M-w (fwd m+w, bwd m) pairs,
    then the w remaining backwards. The events, edges and deps are the
    GPipe graph's; only each stage's order differs, so stage s holds at
    most S-s stashed inputs: its ``acts`` buffer has min(S-s, M) slots,
    microbatch m in slot m % slots. Ticks are the earliest lockstep
    ones: an event runs a tick after the previous event of its stage
    and a tick after each message it receives was sent."""
    from .pipeline import one_f_one_b_local
    S, M = int(n_stages), int(n_micro)
    file, line = _loc(one_f_one_b_local)
    g = MpmdGraph(S, schedule_mode="1F1B", n_micro=M,
                  act_shape=act_shape, act_dtype=act_dtype,
                  file=file, line=line)
    ab = g.act_bytes()
    order: Dict[int, List[Tuple[str, int]]] = {}
    for s in range(S):
        w = min(S - 1 - s, M)
        seq = [(FWD, m) for m in range(w)]
        for m in range(M - w):
            seq += [(FWD, m + w), (BWD, m)]
        seq += [(BWD, m) for m in range(M - w, M)]
        order[s] = seq
        g.add_buffer(s, "acts", slots=min(S - s, M), slot_bytes=ab)
    # earliest ticks: each event waits for its stage's previous event and
    # for the events it receives from (fwd from s-1, bwd from s+1)
    tick: Dict[Tuple[int, str, int], int] = {}
    pos = {s: 0 for s in range(S)}
    last = {s: -1 for s in range(S)}
    left = S * 2 * M
    while left:
        progressed = False
        for s in range(S):
            if pos[s] == len(order[s]):
                continue
            ph, m = order[s][pos[s]]
            src = (s - 1, FWD, m) if ph == FWD else (s + 1, BWD, m)
            has_src = (ph == FWD and s > 0) or (ph == BWD and s < S - 1)
            if has_src and src not in tick:
                continue
            t = last[s] + 1
            if has_src:
                t = max(t, tick[src] + 1)
            tick[(s, ph, m)] = t
            last[s] = t
            pos[s] += 1
            left -= 1
            progressed = True
        if not progressed:
            raise RuntimeError("1F1B order has no lockstep schedule")
    ev: Dict[Tuple[int, str, int], Event] = {}
    for s in range(S):
        slots = min(S - s, M)
        for ph, m in order[s]:
            e = g.add_event(s, m, ph, tick=tick[(s, ph, m)])
            if ph == FWD:
                e.writes.append(("acts", m % slots))
            else:
                e.reads.append(("acts", m % slots))
            ev[(s, ph, m)] = e
    for s in range(S):
        for ph, m in order[s]:
            if ph == FWD and s > 0:
                g.connect(ev[(s - 1, FWD, m)], ev[(s, FWD, m)])
            if ph == BWD:
                g.add_dep(ev[(s, FWD, m)].key, ev[(s, BWD, m)].key)
                if s < S - 1:
                    g.connect(ev[(s + 1, BWD, m)], ev[(s, BWD, m)])
    return g


def vpp_graph(n_stages: int, n_micro: int, vpp_degree: int, *,
              act_shape: Tuple[int, ...] = (4, 16),
              act_dtype: str = "float32",
              backward: bool = True,
              schedule_mode: str = "VPP") -> MpmdGraph:
    """Interleaved VPP (``pipeline.vpp_local``): stage s runs chunk v,
    microbatch m at tick s + v*M + m; the round wrap (S-1 -> 0) rides
    stage 0's inter-round buffer — a route with capacity M-S+1, the
    exact delay the scan carry implements. Backward mirrors every edge
    at tick 2*T_f - 1 - t_fwd (the cotangent scan's reversal)."""
    from .pipeline import vpp_local
    S, M, V = int(n_stages), int(n_micro), int(vpp_degree)
    file, line = _loc(vpp_local)
    g = MpmdGraph(S, schedule_mode=schedule_mode, n_micro=M,
                  vpp_degree=V, act_shape=act_shape, act_dtype=act_dtype,
                  file=file, line=line)
    ab = g.act_bytes()
    T_f = V * M + S - 1
    wrap_cap = max(1, M - S + 1)
    if S > 1 and V > 1:
        g.channel_capacity[(S - 1, 0)] = wrap_cap
        g.channel_capacity[(0, S - 1)] = wrap_cap
    for s in range(S):
        g.add_buffer(s, "acts", slots=V * M, slot_bytes=ab)
    # pass 1 creates every event in program (tick) order; pass 2 wires
    # the edges — deferred so an infeasible geometry (M < S, where the
    # wrap producer runs AFTER its consumer's tick) still builds a
    # graph for the checker to REPORT on instead of crashing here.
    ev_f: Dict[Tuple[int, int, int], Event] = {}
    for t in range(T_f):
        for s in range(S):
            tau = t - s
            if 0 <= tau < V * M:
                v, m = divmod(tau, M)
                ev = g.add_event(s, m, FWD, chunk=v, tick=t)
                ev.writes.append(("acts", v * M + m))
                ev_f[(s, m, v)] = ev
    for t in range(T_f):
        for s in range(S):
            tau = t - s
            if 0 <= tau < V * M:
                v, m = divmod(tau, M)
                if s > 0:
                    g.connect(ev_f[(s - 1, m, v)], ev_f[(s, m, v)],
                              tag=(FWD, m, v))
                elif v > 0:      # the inter-round wrap S-1 -> 0
                    g.connect(ev_f[(S - 1, m, v - 1)], ev_f[(s, m, v)],
                              tag=(FWD, m, v - 1))
    if not backward:
        return g
    ev_b: Dict[Tuple[int, int, int], Event] = {}
    for t in range(T_f):
        for s in range(S):          # reversed scan: mirror tick math
            tau = (T_f - 1 - t) - s
            if 0 <= tau < V * M:
                v, m = divmod(tau, M)
                ev = g.add_event(s, m, BWD, chunk=v, tick=T_f + t)
                ev.reads.append(("acts", v * M + m))
                g.add_dep(ev_f[(s, m, v)].key, ev.key)
                ev_b[(s, m, v)] = ev
    for t in range(T_f):
        for s in range(S):
            tau = (T_f - 1 - t) - s
            if 0 <= tau < V * M:
                v, m = divmod(tau, M)
                if s < S - 1:       # reverse of fwd edge s -> s+1
                    g.connect(ev_b[(s + 1, m, v)], ev_b[(s, m, v)],
                              tag=(BWD, m, v))
                elif v < V - 1:     # reverse of the round wrap
                    g.connect(ev_b[(0, m, v + 1)], ev_b[(s, m, v)],
                              tag=(BWD, m, v + 1))
    return g


def zb_graph(n_stages: int, n_micro: int, *,
             act_shape: Tuple[int, ...] = (4, 16),
             act_dtype: str = "float32") -> MpmdGraph:
    """ZBH1 (``zero_bubble.zb_local``): forward is the GPipe scan; the
    backward phase spans 2M+S-1 ticks where stage s runs B (the dx
    half) for bi = t-(S-1-s) and drains the weight-grad stash with W
    at wi = bi - M. B reads the stashed stage input and writes the
    bwd_w frontier; W reads it M ticks later."""
    from .zero_bubble import zb_local
    S, M = int(n_stages), int(n_micro)
    file, line = _loc(zb_local)
    g = MpmdGraph(S, schedule_mode="ZBH1", n_micro=M,
                  act_shape=act_shape, act_dtype=act_dtype,
                  file=file, line=line)
    ab = g.act_bytes()
    T_f = M + S - 1
    for s in range(S):
        g.add_buffer(s, "acts", slots=M, slot_bytes=ab)
        g.add_buffer(s, "wgrad", slots=M, slot_bytes=ab)
    ev_f: Dict[Tuple[int, int], Event] = {}
    for t in range(T_f):
        for s in range(S):
            m = t - s
            if 0 <= m < M:
                ev = g.add_event(s, m, FWD, tick=t)
                ev.writes.append(("acts", m))
                ev_f[(s, m)] = ev
                if s > 0:
                    g.connect(ev_f[(s - 1, m)], ev)
    ev_b: Dict[Tuple[int, int], Event] = {}
    for t in range(2 * M + S - 1):
        for s in range(S - 1, -1, -1):
            bi = t - (S - 1 - s)
            if 0 <= bi < M:
                ev = g.add_event(s, bi, BWD, tick=T_f + t)
                ev.reads.append(("acts", bi))
                ev.writes.append(("wgrad", bi))
                g.add_dep(ev_f[(s, bi)].key, ev.key)
                ev_b[(s, bi)] = ev
                if s < S - 1:
                    g.connect(ev_b[(s + 1, bi)], ev)
        for s in range(S):
            wi = t - (S - 1 - s) - M
            if 0 <= wi < M:
                ev = g.add_event(s, wi, W, tick=T_f + t)
                ev.reads.append(("wgrad", wi))
                g.add_dep(ev_b[(s, wi)].key, ev.key)
    return g


def zbvpp_graph(n_stages: int, n_micro: int, vpp_degree: int, *,
                act_shape: Tuple[int, ...] = (4, 16),
                act_dtype: str = "float32") -> MpmdGraph:
    """ZBVPP (``zero_bubble.zbvpp_local``): forward mirrors vpp_local
    with a flat [V*M] input stash; backward reverses the interleaved
    flow — for sig = u - (S-1-s), chunk v = (V-1) - sig//M runs its B
    tick, the stage-(S-1) wrap buffer mirrors forward's stage-0 buffer
    with the same M-S+1 delay, and W drains at sig - V*M."""
    from .zero_bubble import zbvpp_local
    S, M, V = int(n_stages), int(n_micro), int(vpp_degree)
    file, line = _loc(zbvpp_local)
    g = MpmdGraph(S, schedule_mode="ZBVPP", n_micro=M, vpp_degree=V,
                  act_shape=act_shape, act_dtype=act_dtype,
                  file=file, line=line)
    ab = g.act_bytes()
    T_f = V * M + S - 1
    wrap_cap = max(1, M - S + 1)
    if S > 1 and V > 1:
        g.channel_capacity[(S - 1, 0)] = wrap_cap
        g.channel_capacity[(0, S - 1)] = wrap_cap
    for s in range(S):
        g.add_buffer(s, "acts", slots=V * M, slot_bytes=ab)
        g.add_buffer(s, "wgrad", slots=V * M, slot_bytes=ab)
    ev_f: Dict[Tuple[int, int, int], Event] = {}
    for t in range(T_f):
        for s in range(S):
            tau = t - s
            if 0 <= tau < V * M:
                v, m = divmod(tau, M)
                ev = g.add_event(s, m, FWD, chunk=v, tick=t)
                ev.writes.append(("acts", v * M + m))
                ev_f[(s, m, v)] = ev
    for t in range(T_f):                 # deferred wiring (see vpp)
        for s in range(S):
            tau = t - s
            if 0 <= tau < V * M:
                v, m = divmod(tau, M)
                if s > 0:
                    g.connect(ev_f[(s - 1, m, v)], ev_f[(s, m, v)],
                              tag=(FWD, m, v))
                elif v > 0:
                    g.connect(ev_f[(S - 1, m, v - 1)], ev_f[(s, m, v)],
                              tag=(FWD, m, v - 1))
    ev_b: Dict[Tuple[int, int, int], Event] = {}
    for u in range(2 * V * M + S - 1):
        for s in range(S - 1, -1, -1):
            sig = u - (S - 1 - s)
            if 0 <= sig < V * M:
                rv, m = divmod(sig, M)
                v = (V - 1) - rv
                ev = g.add_event(s, m, BWD, chunk=v, tick=T_f + u)
                ev.reads.append(("acts", v * M + m))
                ev.writes.append(("wgrad", v * M + m))
                g.add_dep(ev_f[(s, m, v)].key, ev.key)
                ev_b[(s, m, v)] = ev
        for s in range(S):
            sig_w = u - (S - 1 - s) - V * M
            if 0 <= sig_w < V * M:
                rv, m = divmod(sig_w, M)
                v = (V - 1) - rv
                ev = g.add_event(s, m, W, chunk=v, tick=T_f + u)
                ev.reads.append(("wgrad", v * M + m))
                g.add_dep(ev_b[(s, m, v)].key, ev.key)
    for u in range(2 * V * M + S - 1):   # deferred wiring (see vpp)
        for s in range(S - 1, -1, -1):
            sig = u - (S - 1 - s)
            if 0 <= sig < V * M:
                rv, m = divmod(sig, M)
                v = (V - 1) - rv
                if s < S - 1:
                    g.connect(ev_b[(s + 1, m, v)], ev_b[(s, m, v)],
                              tag=(BWD, m, v))
                elif v < V - 1:     # the stage-(S-1) wrap (0 -> S-1)
                    g.connect(ev_b[(0, m, v + 1)], ev_b[(s, m, v)],
                              tag=(BWD, m, v + 1))
    return g


def schedule_graph(schedule_mode: str, n_stages: int, n_micro: int,
                   vpp_degree: int = 1, *,
                   act_shape: Tuple[int, ...] = (4, 16),
                   act_dtype: str = "float32",
                   backward: bool = True) -> MpmdGraph:
    """Dispatch on the schedule mode (same vocabulary as
    ``pipeline.schedule_stats``, which also stamps the graph's
    bubble-accounting expectation into ``meta['stats']``). "1F1B" with
    its backward is ``one_f_one_b_graph``, whose span is its own, so it
    carries no stats."""
    mode = (schedule_mode or "FThenB").upper()
    # MPMD variants run the SAME event graphs, driven by the host
    # runtime (mpmd_runtime.MpmdDriver) instead of one SPMD program
    if mode == "MPMD":
        mode = "FTHENB" if vpp_degree <= 1 else "VPP"
    elif mode.startswith("MPMD-"):
        mode = mode[len("MPMD-"):]
    kw = dict(act_shape=act_shape, act_dtype=act_dtype)
    if mode == "1F1B" and backward:
        return one_f_one_b_graph(n_stages, n_micro, **kw)
    if mode in ("", "FTHENB", "1F1B"):
        g = gpipe_graph(n_stages, n_micro, backward=backward, **kw)
    elif mode == "VPP":
        g = vpp_graph(n_stages, n_micro, vpp_degree, backward=backward,
                      **kw)
    elif mode == "ZBH1":
        g = zb_graph(n_stages, n_micro, **kw)
    elif mode == "ZBVPP":
        g = zbvpp_graph(n_stages, n_micro, vpp_degree, **kw)
    else:
        raise ValueError(f"unknown schedule_mode {schedule_mode!r}")
    if n_stages > 1:
        from .pipeline import schedule_stats
        g.meta["stats"] = schedule_stats(mode, n_stages, n_micro,
                                         vpp_degree)
    return g


# ---------------------------------------------------------------------------
# non-pipeline phase graphs — the rest of the MULTICHIP ledger
# ---------------------------------------------------------------------------

def single_stage_graph(n_micro: int = 1, *,
                       act_shape: Tuple[int, ...] = (4, 16),
                       act_dtype: str = "float32",
                       subject: str = "") -> MpmdGraph:
    """Degenerate one-stage schedule: pure-SPMD phases (hybrid, ep,
    dcn) have no cross-stage events; the verifier confirms the trivial
    graph is consistent (no MPMD hazards by construction)."""
    g = MpmdGraph(1, schedule_mode="", n_micro=n_micro,
                  act_shape=act_shape, act_dtype=act_dtype,
                  subject=subject or f"mpmd(single-stage, M={n_micro})")
    prev = None
    for m in range(n_micro):
        ev = g.add_event(0, m, FWD, tick=m)
        if prev is not None:
            g.add_dep(prev.key, ev.key)
        prev = ev
    return g


def ring_graph(ring_degree: int, *, hops: Optional[int] = None,
               act_shape: Tuple[int, ...] = (2, 2, 8, 8),
               act_dtype: str = "float32",
               backward: bool = True,
               subject: str = "") -> MpmdGraph:
    """Ring-attention (sep) event structure: R devices each run R
    softmax hops; k/v rotate one hop per tick on the forward ring and
    the gradients counter-rotate on the reverse ring. ``micro`` is the
    hop index — the event at (r, h) consumes the kv block that
    originated on device (r - h) % R."""
    R = int(ring_degree)
    H = int(hops) if hops is not None else R
    g = MpmdGraph(R, schedule_mode="", n_micro=H,
                  act_shape=act_shape, act_dtype=act_dtype,
                  subject=subject or f"mpmd(ring, R={R}, hops={H})")
    ev_f: Dict[Tuple[int, int], Event] = {}
    for h in range(H):
        for r in range(R):
            ev = g.add_event(r, h, FWD, tick=h)
            ev_f[(r, h)] = ev
            if h > 0:
                g.connect(ev_f[((r - 1) % R, h - 1)], ev,
                          tag=("kv", h - 1))
    if not backward:
        return g
    ev_b: Dict[Tuple[int, int], Event] = {}
    for t in range(H):
        h = H - 1 - t
        for r in range(R):
            ev = g.add_event(r, h, BWD, tick=H + t)
            ev_b[(r, h)] = ev
            g.add_dep(ev_f[(r, h)].key, ev.key)
            if h < H - 1:   # counter-rotation: grads ride r+1 -> r
                g.connect(ev_b[((r + 1) % R, h + 1)], ev,
                          tag=("dkv", h + 1))
    return g


def disagg_graph(prefill_workers: int, decode_workers: int,
                 n_requests: int, *,
                 kv_shape: Tuple[int, ...] = (8, 64),
                 act_dtype: str = "float32",
                 pool_slots: int = 2,
                 subject: str = "") -> MpmdGraph:
    """Disaggregated serving (prefill -> decode KV migration,
    ``inference/disagg.py``): request r prefills on worker r % P, then
    its KV pages migrate to decode worker P + r % D. The decode pool
    bounds the migrations in flight on a route (``pool_slots``): the
    back-pressure a driver must respect."""
    P, D, N = int(prefill_workers), int(decode_workers), int(n_requests)
    g = MpmdGraph(P + D, schedule_mode="", n_micro=N,
                  act_shape=kv_shape, act_dtype=act_dtype,
                  subject=subject or f"mpmd(disagg, P={P}, D={D}, "
                                     f"reqs={N})")
    for p in range(P):
        for d in range(D):
            g.channel_capacity[(p, P + d)] = pool_slots
    for r in range(N):
        p, d = r % P, P + (r % D)
        pre = g.add_event(p, r, FWD, tick=2 * (r // P))
        dec = g.add_event(d, r, FWD, tick=2 * (r // P) + 1)
        g.connect(pre, dec, shape=kv_shape, tag=("kv", r))
    return g


# ---------------------------------------------------------------------------
# higher-level extractors: PipelineLayer / PipelineParallel / planner Plan
# ---------------------------------------------------------------------------

def pipeline_graph(pipe, *, n_micro: Optional[int] = None,
                   schedule_mode: Optional[str] = None,
                   vpp_degree: Optional[int] = None,
                   act_shape: Optional[Tuple[int, ...]] = None,
                   act_dtype: str = "float32") -> MpmdGraph:
    """Extract the event graph of a PipelineLayer / PipelineParallel —
    the same n_micro/mode/vpp resolution as ``analysis.lint_pipeline``,
    with per-stage descriptors from the stage item lists."""
    model = None
    if hasattr(pipe, "_layers") and hasattr(pipe, "accumulate_steps"):
        model, pipe = pipe, pipe._layers
    S = int(pipe.get_num_stages())
    V = int(vpp_degree if vpp_degree is not None else
            (model.vpp_degree if model is not None
             else getattr(pipe, "_num_virtual_stages", 1)) or 1)
    M = int(n_micro if n_micro is not None else
            (model.accumulate_steps if model is not None else S) or S)
    mode = (schedule_mode if schedule_mode is not None else
            (model.schedule_mode if model is not None else "")) or \
        ("VPP" if V > 1 else "FThenB")
    g = schedule_graph(mode, S, M, V,
                       act_shape=act_shape or (4, 16),
                       act_dtype=act_dtype)
    for s in range(S):
        try:
            items = pipe.stage_items(s)
        except Exception:
            items = []
        g.descriptors[s] = {"stage_items": len(items)}
    g.subject = (f"mpmd({type(pipe).__name__}, {mode}, S={S}, M={M}"
                 + (f", V={V}" if V > 1 else "") + ")")
    return g


def plan_graph(spec, plan, dims: Optional[dict] = None) -> MpmdGraph:
    """The event graph a planner ``Plan`` implies: it comes with the
    planner."""
    raise NotImplementedError(
        "plan_graph needs the auto-parallel planner, which comes with the "
        "analysis slice of the port (ROADMAP item 4)")


__all__ = [
    "FWD", "BWD", "W", "Msg", "Event", "BufferSpec", "MpmdGraph",
    "gpipe_graph", "one_f_one_b_graph", "vpp_graph", "zb_graph",
    "zbvpp_graph",
    "schedule_graph", "single_stage_graph", "ring_graph",
    "disagg_graph", "pipeline_graph", "plan_graph",
]
