"""The port Engine's request lifecycle and observability plane on the
CPU, held to the JAX Engine with the same weights (``bridge.py``), the
same prompts (numpy, fixed seed) and the same virtual clock, which the
tests advance by hand between steps.

The contracts: deadlines (waiting and mid-decode), queue timeouts and
``cancel`` at every point of the lifecycle (waiting, mid-prefill,
decoding, preempted, retired, unknown) give the JAX engine's outputs,
counters and free-page trajectory, at multi_tick 1 and 8 and under
chunked prefill; the multi-tick deadline clamp shrinks fused dispatches
as the JAX one does; every Output's span timeline (QUEUED -> PREFILL
slices -> DECODE -> ... -> FINISHED / FAILED, through preemption and a
snapshot/restore) equals the JAX engine's phase for phase, slot for
slot and time for time, passes ``validate_timeline``, and exports to
the same chrome-trace JSON; the tracing primitives answer as the JAX
ones do; a labeled engine writes its metrics twice (aggregate and
``serving.<label>.…``); the host/device split of each step adds up, and
the windowed attribution books host work hidden under a dispatch as
overlap.
"""
import json

import numpy as np
import pytest
import torch

from paddle_tpu import monitor as jmon
from paddle_tpu.inference import tracing as jtracing
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.engine import SamplingParams as JaxParams
from paddle_tpu_torch import monitor
from paddle_tpu_torch.inference import Engine, SamplingParams, tracing

from test_torch_engine import _prompts, torch_one_thread
from test_torch_llama import make_pair

pytestmark = pytest.mark.usefixtures("torch_one_thread")

LIFECYCLE = ["serving.timeouts", "serving.cancelled", "serving.failed",
             "serving.finished", "serving.preemptions", "serving.tokens",
             "serving.multi_tick.dispatches", "serving.multi_tick.ticks",
             "serving.multi_tick.clamp.deadline",
             "serving.multi_tick.clamp.max_new",
             "serving.multi_tick.clamp.pages", "serving.prefill_slices"]


def _counts(mon):
    return {n: mon.counter(n).get() for n in LIFECYCLE}


def _record(o):
    return (o.token_ids, o.finish_reason, o.error, o.spans, o.ttft_ms,
            o.tpot_ms, o.preemptions)


def _run_events(eng, params_cls, clk, events, max_steps=200):
    """Drive ``events`` ({step: [event, ...]}) into ``eng``: ("clock",
    t) sets the virtual clock, ("add", prompt, params kwargs) queues a
    request, ("cancel", rid) cancels one, ("cancel_if", rid, state)
    cancels it when it is in ``state``, ("est", ms) sets the deadline
    clamp's tick estimate. Returns ({req_id: record}, [cancel results],
    [pages_free a step])."""
    outs, cancels, free = {}, [], []
    n_add = sum(1 for evs in events.values() for e in evs if e[0] == "add")
    for step in range(max_steps):
        for ev in events.get(step, []) + events.get("each", []):
            if ev[0] == "clock":
                clk["t"] = ev[1]
            elif ev[0] == "add":
                eng.add_request(ev[1], params_cls(**ev[2]))
            elif ev[0] == "est":
                eng._tick_est_ms = ev[1]
            elif ev[0] == "cancel" or (
                    ev[0] == "cancel_if" and ev[1] in eng.requests
                    and eng.requests[ev[1]].state == ev[2]):
                o = eng.cancel(ev[1])
                cancels.append(None if o is None else _record(o))
                if o is not None:
                    outs[o.req_id] = _record(o)
        for o in eng.step():
            outs[o.req_id] = _record(o)
        free.append(eng.pages_free)
        steps = [k for k in events if k != "each"]
        if len(outs) == n_add and step >= max(steps):
            break
    assert len(outs) == n_add
    return outs, cancels, free


def _both(events, jkw, tkw=None, net_kw=None):
    """The same events on the JAX engine and the port engine, each on
    its own virtual clock: (JAX result, port result, JAX counters, port
    counters)."""
    jnet, tnet, _ = make_pair(**(net_kw or {}))
    res = []
    for cls, net, params, mon, extra in (
            (JaxEngine, jnet, JaxParams, jmon, {}),
            (Engine, tnet, SamplingParams, monitor, {"device": "cpu"})):
        for n in LIFECYCLE:
            mon.counter(n).reset()
        clk = {"t": 0.0}
        kw = jkw if cls is JaxEngine or tkw is None else tkw
        eng = cls(net, clock=lambda: clk["t"], **kw, **extra)
        res.append(_run_events(eng, params, clk, events))
        res.append(_counts(mon))
        assert eng.pages_free == eng.pool_pages
        if cls is Engine:
            assert eng.check_invariants() == [] and not eng.requests
        else:
            eng.close()
    return res[0], res[2], res[1], res[3]


def _assert_timelines(outs):
    for rec in outs.values():
        spans = rec[3]
        assert tracing.validate_timeline(spans) == [], spans
        assert spans[0]["phase"] == tracing.QUEUED
        assert spans[-1]["phase"] == (tracing.FINISHED if rec[2] is None
                                      else tracing.FAILED)


@pytest.mark.parametrize("config", ["mt1", "mt8", "chunked"])
def test_deadlines_timeouts_cancel_match_jax(config):
    """Deadlines (a waiting request that cannot make it, a mid-decode
    expiry keeping its partial tokens), a queue timeout, and cancels of
    a waiting, a mid-prefill (chunked) and a decoding request, then of a
    retired and an unknown id: every output, span and counter equals the
    JAX engine's."""
    p = _prompts(np.random.default_rng(0), (5, 7, 4, 6, 30, 9, 3))
    kw = dict(max_slots=2, page_size=8, pool_pages=32, max_context=64,
              prefill_bucket=8)
    kw.update({"mt1": {}, "mt8": dict(multi_tick=8),
               "chunked": dict(max_prefill_tokens_per_step=8)}[config])
    events = {
        0: [("add", p[0], dict(max_new_tokens=10, deadline_ms=10_000.0)),
            ("add", p[1], dict(max_new_tokens=12, deadline_ms=50.0)),
            ("add", p[2], dict(max_new_tokens=8, max_queue_steps=2)),
            ("add", p[3], dict(max_new_tokens=30, deadline_ms=40.0))],
        2: [("clock", 0.02)],
        3: [("clock", 0.1)],          # r1 (decoding) and r3 (waiting) expire
        5: [("add", p[4], dict(max_new_tokens=6)),
            ("add", p[5], dict(max_new_tokens=20))],
        6: [("cancel_if", 4, "PREFILL"), ("clock", 0.15)],
        9: [("cancel_if", 5, "DECODE"), ("cancel_if", 5, "WAITING")],
        10: [("add", p[6], dict(max_new_tokens=5)), ("cancel", 6),
             ("cancel", 6), ("cancel", 99)],
    }
    (jout, jcan, jfree), (tout, tcan, tfree), jc, tc = _both(events, kw)
    assert tout == jout
    assert tcan == jcan
    assert tfree == jfree
    assert tc == jc
    reasons = {rec[1] for rec in tout.values()}
    assert {"deadline", "queue_timeout", "cancelled"} <= reasons
    assert tcan[-2:] == [None, None]               # retired, unknown
    mid = [rec for rec in tout.values()
           if rec[1] == "deadline" and rec[0]]
    assert mid                                     # partial tokens kept
    if config == "chunked":
        assert tout[4][1] == "cancelled" and tout[4][0] == []
    _assert_timelines(tout)


def test_cancel_preempted_request_matches_jax():
    """A pool too small for both sequences preempts the younger one; a
    cancel while it is PREEMPTED drops its resume state, returns its
    partial tokens, and the other request finishes as in the JAX
    engine."""
    p = _prompts(np.random.default_rng(1), (4, 3))
    kw = dict(max_slots=2, page_size=4, pool_pages=4, max_context=16,
              prefill_bucket=4, watermark_pages=0)
    events = {0: [("add", p[0], dict(max_new_tokens=10)),
                  ("add", p[1], dict(max_new_tokens=10))],
              "each": [("cancel_if", 1, "PREEMPTED")]}
    (jout, jcan, jfree), (tout, tcan, tfree), jc, tc = _both(events, kw)
    assert (tout, tcan, tfree, tc) == (jout, jcan, jfree, jc)
    assert tout[1][1] == "cancelled" and tout[1][0]
    assert tc["serving.preemptions"] >= 1
    phases = [s["phase"] for s in tout[1][3]]
    assert tracing.PREEMPTED in phases
    _assert_timelines(tout)


def test_multi_tick_deadline_clamp_matches_jax():
    """multi_tick=8 with a tick estimate on the virtual clock (held at
    10 ms before every step; the clock advances 10 ms a step): the
    deadline leg shrinks the fused k toward the nearest deadline
    (serving.multi_tick.clamp.deadline), the DECODE spans carry the
    fused ticks, and tokens, spans and counters equal the JAX
    engine's."""
    p = _prompts(np.random.default_rng(2), (5, 9, 6))
    kw = dict(max_slots=3, page_size=8, pool_pages=64, max_context=64,
              prefill_bucket=8, multi_tick=8)
    events = {0: [("add", p[0], dict(max_new_tokens=30,
                                     deadline_ms=60.0)),
                  ("add", p[1], dict(max_new_tokens=24)),
                  ("add", p[2], dict(max_new_tokens=18,
                                     deadline_ms=400.0))],
              "each": [("est", 10.0)]}
    events.update({s: [("clock", 0.01 * s)] for s in range(1, 40)})
    (jout, _, jfree), (tout, _, tfree), jc, tc = _both(events, kw)
    assert tout == jout and tfree == jfree and tc == jc
    assert tc["serving.multi_tick.clamp.deadline"] > 0
    assert tc["serving.multi_tick.dispatches"] > 0
    assert tout[0][1] == "deadline"
    bumps = [s.get("detail", {}).get("multi_ticks", 0)
             for rec in tout.values() for s in rec[3]
             if s["phase"] == tracing.DECODE]
    assert sum(bumps) > 0
    _assert_timelines(tout)


def test_deadline_clamp_unit_matches_jax():
    """``_deadline_ticks`` / ``_multi_k`` on one engine state: no
    estimate means no clamp; 50 ms left at 10 ms a tick is 5 ticks
    (bucket 4); 5 ms left is one tick — the JAX engine's answers."""
    jnet, tnet, _ = make_pair()
    kw = dict(max_slots=2, page_size=8, pool_pages=64, max_context=64,
              multi_tick=8)
    got = []
    for cls, net, params, extra in (
            (JaxEngine, jnet, JaxParams, {}),
            (Engine, tnet, SamplingParams, {"device": "cpu"})):
        t = [0.0]
        eng = cls(net, clock=lambda: t[0], **kw, **extra)
        eng.add_request(_prompts(np.random.default_rng(3), (5,))[0],
                        params(max_new_tokens=20, deadline_ms=50.0))
        eng.step()
        active = [i for i in range(eng.max_slots)
                  if eng._slots[i] is not None]
        row = [eng._deadline_ticks(active)]
        eng._tick_est_ms = 10.0
        row += [eng._deadline_ticks(active), eng._multi_k(active, "greedy")]
        t[0] = 0.045
        row += [eng._deadline_ticks(active), eng._multi_k(active, "greedy")]
        got.append(row)
    assert got[0] == got[1] == [8, 5, 4, 1, 1]


# -- span timelines ----------------------------------------------------------

def _span_events(p, restore_at=None):
    events = {0: [("add", p[0], dict(max_new_tokens=8)),
                  ("add", p[1], dict(max_new_tokens=10))],
              2: [("add", p[2], dict(max_new_tokens=6))]}
    events.update({s: events.get(s, []) + [("clock", 0.004 * s)]
                   for s in range(1, 30)})
    return events


@pytest.mark.parametrize("config", ["plain", "preempt", "mt8_chunked"])
def test_timelines_match_jax(config):
    """Every request's spans across the lifecycle — queue waits, prefill
    slices (chunked), decode stints with fused ticks (multi-tick),
    preemption and resume — equal the JAX engine's on the same virtual
    clock, pass validate_timeline, and export to the same chrome-trace
    JSON."""
    p = _prompts(np.random.default_rng(4), (5, 9, 3))
    kw = dict(max_slots=2, page_size=8, pool_pages=64, max_context=64,
              prefill_bucket=8)
    if config == "preempt":
        kw = dict(max_slots=2, page_size=4, pool_pages=6, max_context=32,
                  prefill_bucket=4, watermark_pages=0)
    elif config == "mt8_chunked":
        kw.update(multi_tick=8, max_prefill_tokens_per_step=8)
    (jout, _, _), (tout, _, _), jc, tc = _both(_span_events(p), kw)
    assert tout == jout and tc == jc
    _assert_timelines(tout)
    if config == "preempt":
        assert tc["serving.preemptions"] > 0
    jtrace = jtracing.build_serving_trace({r: v[3] for r, v in
                                           jout.items()})
    ttrace = tracing.build_serving_trace({r: v[3] for r, v in
                                          tout.items()})
    assert json.dumps(ttrace, sort_keys=True) == \
        json.dumps(jtrace, sort_keys=True)


def test_restore_stitches_timeline_as_jax():
    """A snapshot mid-decode, restored on a fresh engine of the same
    framework: each request retires ONE contiguous timeline whose seam
    is a PREEMPTED span tagged kind=restore, equal to the JAX engine's
    through the same snapshot/restore."""
    jnet, tnet, _ = make_pair()
    p = _prompts(np.random.default_rng(5), (5, 7))
    kw = dict(max_slots=2, page_size=8, pool_pages=64, max_context=64)
    got = []
    for cls, net, params, extra in (
            (JaxEngine, jnet, JaxParams, {}),
            (Engine, tnet, SamplingParams, {"device": "cpu"})):
        clk = {"t": 0.0}
        eng = cls(net, clock=lambda: clk["t"], **kw, **extra)
        for x in p:
            eng.add_request(x, params(max_new_tokens=8))
        done = {}
        for s in range(3):
            clk["t"] = 0.003 * s
            done.update({o.req_id: o for o in eng.step()})
        snap = eng.snapshot()
        clk["t"] = 0.05
        eng2 = cls(net, clock=lambda: clk["t"], **kw, **extra)
        eng2.restore(snap)
        for s in range(60):
            clk["t"] = 0.05 + 0.003 * s
            done.update({o.req_id: o for o in eng2.step()})
            if len(done) == 2:
                break
        got.append({r: (o.token_ids, o.spans) for r, o in done.items()})
    assert got[1] == got[0]
    for toks, spans in got[1].values():
        assert tracing.validate_timeline(spans) == []
        assert any(s.get("detail", {}).get("kind") == "restore"
                   for s in spans)


def test_tracing_primitives_match_jax(tmp_path):
    """open_span / close_open / seal (idempotent) / bump_open /
    restore_spans / validate_timeline / phase_shares and the export
    round trip answer as the JAX module's on the same span logs."""
    def build(tr):
        a, b = [], []
        tr.open_span(a, tr.QUEUED, 0.0, "e0")
        tr.open_span(a, tr.PREFILL, 1.5, "e0", slot=1, start=0, tokens=8)
        tr.open_span(a, tr.DECODE, 2.0, "e0", slot=1)
        tr.bump_open(a, tr.DECODE, multi_ticks=8, multi_dispatches=1)
        tr.bump_open(a, tr.DECODE, multi_ticks=4, multi_dispatches=1)
        tr.seal(a, tr.FAILED, 7.25, "e0", reason="deadline")
        tr.seal(a, tr.FINISHED, 9.0, "e0")
        tr.open_span(b, tr.QUEUED, 1.0, "e1")
        b = tr.restore_spans(b, 3.0, 4.0, "e1", True)
        tr.seal(b, tr.FINISHED, 5.0, "e1")
        bad = [{"phase": "DECODE", "t0_ms": 1.0, "t1_ms": 0.5,
                "origin": "x"}, {"phase": "QUEUED", "t0_ms": 2.0,
                                 "t1_ms": None, "origin": "x"}]
        trace = tr.build_serving_trace({0: a, 1: b})
        path = tr.export_serving_trace({0: a, 1: b},
                                       str(tmp_path / f"{id(tr)}.json"))
        with open(path) as fh:
            back = tr.timelines_from_trace(json.load(fh))
        return (a, b, tr.validate_timeline(a), tr.validate_timeline(bad),
                tr.phase_shares(a), tr.current_phase(b), trace,
                [tr.validate_timeline(s, tol_ms=0.01)
                 for s in back.values()])

    got, want = build(tracing), build(jtracing)
    assert got == want
    assert got[2] == [] and got[3] and got[7] == [[], []]


# -- metrics -----------------------------------------------------------------

def test_labeled_engine_dual_writes_and_labels_spans():
    """monitor.scope(label) writes the aggregate and its
    serving.<label>. twin (scope(None) is a passthrough); an Engine with
    ``label`` names itself in every span's origin and writes its serving
    counters, gauges and histograms under both names."""
    sc = monitor.scope("unit")
    assert sc.scoped_name("serving.ttft_ms") == "serving.unit.ttft_ms"
    assert sc.scoped_name("other.x") == "unit.other.x"
    c0 = monitor.counter("serving.obs_scope_test").get()
    sc.counter("serving.obs_scope_test").increase(3)
    assert monitor.counter("serving.obs_scope_test").get() == c0 + 3
    assert monitor.counter("serving.unit.obs_scope_test").get() >= 3
    assert monitor.scope(None).counter("serving.obs_scope_test") is \
        monitor.counter("serving.obs_scope_test")
    _, tnet, _ = make_pair()
    monitor.reset()
    eng = Engine(tnet, device="cpu", label="replica7", max_slots=2,
                 page_size=8, pool_pages=32, max_context=64)
    outs = eng.run([(x, SamplingParams(max_new_tokens=4))
                    for x in _prompts(np.random.default_rng(6), (5, 3))])
    assert {s["origin"] for o in outs for s in o.spans} == {"replica7"}
    for name in ("serving.steps", "serving.tokens", "serving.requests",
                 "serving.finished"):
        twin = "serving.replica7." + name[len("serving."):]
        assert monitor.counter(twin).get() == monitor.counter(name).get() > 0
    for name in ("hist.ttft_ms", "hist.queue_wait_ms", "hist.tick_ms",
                 "hist.host_ms_per_tick", "hist.overlap_ms_per_tick"):
        assert monitor.histogram("serving.replica7." + name).count == \
            monitor.histogram("serving." + name).count > 0


def test_host_device_tick_attribution():
    """Each step splits its wall time into host and device shares (the
    gauges hold the last step, the histograms every step): host +
    device equals the step's wall time, overlap never exceeds the device
    share; and the windowed rule books host work done under a blocking
    dispatch as device time and overlap, while a wait that returns at
    once is charged as measured."""
    names = ("host_ms_per_tick", "device_ms_per_tick",
             "overlap_ms_per_tick")
    for n in names:
        monitor.histogram("serving.hist." + n).reset()
    monitor.histogram("serving.hist.tick_ms").reset()
    _, tnet, _ = make_pair()
    eng = Engine(tnet, device="cpu", max_slots=2, page_size=8,
                 pool_pages=32, max_context=64)
    eng.run([(x, SamplingParams(max_new_tokens=4))
             for x in _prompts(np.random.default_rng(7), (5, 3))])
    host, dev, ov = (monitor.histogram("serving.hist." + n) for n in names)
    tick = monitor.histogram("serving.hist.tick_ms")
    assert host.count == dev.count == ov.count == tick.count == eng._steps
    assert host.sum + dev.sum == pytest.approx(tick.sum, rel=1e-6)
    assert 0.0 <= ov.sum <= dev.sum

    class Blocking:
        """A device result whose copy to the host waits 20 ms."""

        def cpu(self):
            import time
            time.sleep(0.02)
            return torch.zeros(1)

    import time
    eng._device_s = eng._overlap_s = 0.0
    t_dispatch = time.perf_counter() - 0.05     # 50 ms of host work hid
    eng._sync_timed((Blocking(),), t_dispatch, 0.0)
    assert eng._device_s >= 0.07 and eng._overlap_s >= 0.049
    eng._device_s = eng._overlap_s = 0.0
    eng._sync_timed((torch.zeros(1),), time.perf_counter() - 0.05, 0.0)
    assert eng._overlap_s == 0.0 and eng._device_s < 0.01
