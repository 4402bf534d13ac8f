"""The port's serving reliability layer (``paddle_tpu_torch.inference
.reliability`` and the Engine's fault sites, isolation wrappers,
invariant audit and snapshot/restore) on the CPU, held to the JAX
package with the same weights (``bridge.py``) and prompts from numpy
with a fixed seed.

The contracts: the injector and its plans fire the JAX classes'
sequence for the same seed, rate, sites and plan; forced collisions and
stale entries degrade prefix hits to misses as in the JAX cache; under
the same seeded ``FaultInjector`` on a staggered trace the port engine
and the JAX engine agree on every output (tokens, finish reason, error),
on the injector's counts, on the serving counters and on the free-page
trajectory — at multi_tick 1 and 8, with the prefix cache, with a draft
model and with ERNIE-MoE; the isolation wrappers fail exactly the
request the fault hit; a snapshot restores on a fresh engine with the
uninterrupted run's tokens (greedy and seeded sampling, prefix cache and
speculation on), a greedy snapshot the JAX engine wrote restores in the
port with the JAX run's tokens, and the version and fingerprint errors
are the reference's; the flags arm an injector and the debug audit; a
stalled ``run`` writes a snapshot. (Sampled tokens are compared within
the port only: JAX threefry keys cannot be reproduced in PyTorch.)
"""
import json
import time

import numpy as np
import pytest

from paddle_tpu import monitor as jmon
from paddle_tpu.inference import allocator as jalloc
from paddle_tpu.inference import prefix_cache as jpc
from paddle_tpu.inference import reliability as jrel
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.engine import SamplingParams as JaxParams
from paddle_tpu_torch import monitor
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.inference import (Engine, FaultInjector, FaultPlan,
                                        PageAllocator, SamplingParams)
from paddle_tpu_torch.inference import prefix_cache as tpc
from paddle_tpu_torch.inference import reliability as trel

from test_torch_engine import _prompts, torch_one_thread
from test_torch_llama import make_pair
from test_torch_moe import make_ernie_pair
from test_torch_speculative import _draft_of

pytestmark = pytest.mark.usefixtures("torch_one_thread")

#: the serving counters the chaos parity compares (plus every
#: serving.fault_injected.<site>)
COUNTERS = ["serving.timeouts", "serving.cancelled",
            "serving.nan_quarantines", "serving.step_errors",
            "serving.invariant_repairs", "serving.preemptions",
            "serving.failed", "serving.finished", "serving.tokens"]

#: the engine geometry of the chaos traces: 12 pages for 3 slots of up
#: to 4 pages each, so growth preempts
KW = dict(max_slots=3, page_size=8, pool_pages=12, max_context=64,
          prefill_bucket=8)


def _counts(mon):
    snap = mon.snapshot()
    return {k: v for k, v in snap.items()
            if k in COUNTERS or k.startswith("serving.fault_injected.")}


def _trace(seed=0):
    """A staggered greedy trace: {step: [(prompt, max_new), ...]}."""
    rng = np.random.default_rng(seed)
    p = _prompts(rng, (5, 9, 3, 7, 12, 6, 10, 4))
    return {0: [(p[0], 12), (p[1], 9)], 2: [(p[2], 14), (p[3], 8)],
            4: [(p[4], 10)], 6: [(p[5], 11), (p[6], 7)], 9: [(p[7], 13)]}


def _chaos(eng, params_cls, schedule, max_steps=300):
    """Drive ``schedule`` into ``eng`` until every request retired:
    ({req_id: (tokens, finish_reason, error)}, [pages_free a step])."""
    outs, free = {}, []
    total = sum(len(v) for v in schedule.values())
    for step in range(max_steps):
        for prompt, n in schedule.get(step, []):
            eng.add_request(prompt, params_cls(max_new_tokens=n))
        for o in eng.step():
            outs[o.req_id] = (o.token_ids, o.finish_reason, o.error)
        free.append(eng.pages_free)
        if len(outs) == total and step >= max(schedule):
            break
    assert len(outs) == total
    return outs, free


# -- the injector ------------------------------------------------------------

@pytest.mark.parametrize("seed,rate,sites", [
    (7, 0.3, None), (8, 0.05, None),
    (3, 0.5, ("decode.nan", "alloc.exhausted", "spec.disagree"))])
def test_fault_injector_fires_the_jax_sequence(seed, rate, sites):
    """The same (seed, rate, sites) and query order fire the JAX
    injector's schedule: both draw from numpy's default_rng in query
    order, fired or not, and both record the same counts."""
    j = jrel.FaultInjector(seed=seed, rate=rate, sites=sites)
    t = FaultInjector(seed=seed, rate=rate, sites=sites)
    n = len(trel.FAULT_SITES)
    order = [trel.FAULT_SITES[i % n] for i in range(120)]
    got = [(t.fire(s), int(t.rng.integers(0, 5)) if k % 7 == 0 else None)
           for k, s in enumerate(order)]
    want = [(j.fire(s), int(j.rng.integers(0, 5)) if k % 7 == 0 else None)
            for k, s in enumerate(order)]
    assert got == want
    assert t.counts == j.counts and t.total_injected == j.total_injected
    assert trel.FAULT_SITES == jrel.FAULT_SITES
    assert trel.SNAPSHOT_VERSION == jrel.SNAPSHOT_VERSION
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector(sites=("decode.nan", "bogus.site"))
    with pytest.raises(ValueError, match="unknown fault site"):
        t.fire("nope")


def test_fault_plan_parse_and_step_gating_match_jax():
    """A plan fires each entry once, at or after its step, ahead of the
    rate draws — the JAX plan's answers query for query."""
    spec = "5:decode.nan, 2:alloc.exhausted, 2:decode.nan"
    j = jrel.FaultInjector(seed=1, rate=0.2,
                           plan=jrel.FaultPlan.parse(spec))
    t = FaultInjector(seed=1, rate=0.2, plan=FaultPlan.parse(spec))
    seq = []
    for inj in (j, t):
        out = []
        for step in (0, 1, 3, 3, 5, 6):
            inj.on_step(step)
            out += [inj.fire(s) for s in ("decode.nan", "alloc.exhausted",
                                          "prefill.nan")]
        seq.append((out, inj.counts, inj.plan.pending))
    assert seq[0] == seq[1]
    assert seq[1][2] == []
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan([(1, "nope")])


# -- the audit and the prefix-cache faults -----------------------------------

def test_allocator_check_invariants_matches_jax():
    """Refcount skew, a leak, free-list corruption and a vanished page:
    the port allocator's findings and repairs equal the JAX one's."""
    def scenario(al):
        log = []
        a = al.alloc(3, seq="a")
        al.share(a[0])
        log.append(al.check_invariants(expected={p: 1 for p in a}))
        log.append(al.check_invariants(expected={p: 1 for p in a},
                                       repair=True))
        log.append(al.check_invariants(expected={a[0]: 1, a[1]: 1},
                                       repair=True))
        al._free.append(a[0])
        log.append(al.check_invariants(repair=True))
        al.free([a[0], a[1]])
        al._free.remove(a[1])
        log.append(al.check_invariants(repair=True))
        log.append((al.check_invariants(), al.free_pages))
        return log

    got = scenario(PageAllocator(6, base=1))
    assert got == scenario(jalloc.PageAllocator(6, base=1))
    assert got[-1] == ([], 6)


def test_collision_and_stale_entry_degrade_to_miss_as_in_jax():
    """force_collision and corrupt_entry (the injector's Generator
    picking the victim) turn a hit into a miss, and check_integrity
    finds and reclaims the stale entry — the JAX cache's answers, op for
    op."""
    def scenario(cache_mod, alloc_mod):
        al = alloc_mod.PageAllocator(8, base=1)
        cache = cache_mod.PrefixCache(al, 4)
        a = list(range(8))
        log = [cache.insert(a, al.alloc(2, seq="a"), 8), cache.lookup(a)]
        cache.force_collision()
        log.append(cache.lookup([9] * 8))          # collides: a miss
        b = [9] * 8
        cache.force_collision(2)                   # insert + lookup
        log += [cache.insert(b, al.alloc(2, seq="b"), 8), cache.lookup(b)]
        cache.force_collision()
        log += [cache.lookup([7] * 8), cache.lookup(a)]
        key = cache.corrupt_entry(np.random.default_rng(0))
        page = cache._store[key].page
        refs = al.refcount(page)
        log += [key, cache.lookup(a), len(cache.check_integrity()) > 0]
        log += [cache.check_integrity(repair=True),
                cache.check_integrity(), len(cache),
                al.refcount(page) == refs - 1, list(al._free),
                dict(al._refs)]
        return log

    got = scenario(tpc, jalloc)
    assert got == scenario(jpc, jalloc)
    assert got[2] == 0 and got[5] == 0       # the collisions missed


# -- chaos parity ------------------------------------------------------------

def _pair(config):
    """(JAX engine kwargs, port engine kwargs, jax net, torch net) of a
    chaos configuration."""
    if config == "ernie_moe":
        jnet, tnet, _ = make_ernie_pair()
        jnet.eval()
        tnet.eval()
        return {}, {}, jnet, tnet
    jnet, tnet, params = make_pair()
    if config == "spec":
        jd, td = _draft_of(jnet, params)
        return (dict(draft_model=jd, spec_k=2),
                dict(draft_model=td, spec_k=2), jnet, tnet)
    kw = {"mt1": {}, "mt8": dict(multi_tick=8),
          "prefix": dict(prefix_cache=True)}[config]
    return kw, dict(kw), jnet, tnet


@pytest.mark.parametrize("config,seed", [
    ("mt1", 3), ("mt8", 3), ("mt8", 4), ("prefix", 5), ("spec", 2),
    ("ernie_moe", 2)])
def test_chaos_matches_jax(config, seed):
    """The JAX engine and the port engine under FaultInjector(seed, 0.1)
    over every site, on one staggered trace with a pool small enough to
    preempt: the same outputs (tokens, finish reason, error), injector
    counts, serving counters and free pages after every step; the
    drained pool balances and the audit ends clean."""
    jkw, tkw, jnet, tnet = _pair(config)
    if config == "ernie_moe":
        jkw = tkw = dict(multi_tick=8)
    jmon.reset()
    monitor.reset()
    ji = jrel.FaultInjector(seed=seed, rate=0.1)
    ti = FaultInjector(seed=seed, rate=0.1)
    jeng = JaxEngine(jnet, fault_injector=ji, **KW, **jkw)
    teng = Engine(tnet, device="cpu", fault_injector=ti, **KW, **tkw)
    jout, jfree = _chaos(jeng, JaxParams, _trace())
    tout, tfree = _chaos(teng, SamplingParams, _trace())
    assert tout == jout
    assert ti.counts == ji.counts and ti.total_injected >= 3
    assert _counts(monitor) == _counts(jmon)
    assert tfree == jfree
    assert teng.check_invariants() == []
    assert teng.leaked_pages() == 0
    if config == "spec":
        assert ti.counts.get("spec.disagree", 0) > 0
    if config == "prefix":
        assert ti.counts.get("prefix.hash_collision", 0) + \
            ti.counts.get("prefix.stale_entry", 0) > 0
    jeng.close()


# -- request isolation under planned faults ----------------------------------

@pytest.mark.parametrize("plan", [
    [(3, "decode.nan")], [(0, "prefill.device_error"),
                          (4, "decode.device_error")],
    [(0, "prefill.nan"), (1, "alloc.exhausted")]],
    ids=["decode_nan", "device_errors", "prefill_nan_alloc"])
def test_planned_faults_match_jax(plan):
    """One planned fault at a time: a NaN slot fails alone, a device
    error skips the tick or requeues the prefill, an exhausted pool
    preempts — outputs and counters the JAX engine's."""
    jnet, tnet, _ = make_pair()
    kw = dict(max_slots=2, page_size=8, pool_pages=32, max_context=64,
              prefill_bucket=8)
    sched = {0: [(p, 12) for p in _prompts(np.random.default_rng(1),
                                           (5, 9))]}
    jmon.reset()
    monitor.reset()
    ji = jrel.FaultInjector(plan=jrel.FaultPlan(list(plan)))
    ti = FaultInjector(plan=FaultPlan(list(plan)))
    jeng = JaxEngine(jnet, fault_injector=ji, **kw)
    jout, jfree = _chaos(jeng, JaxParams, sched)
    tout, tfree = _chaos(Engine(tnet, device="cpu", fault_injector=ti,
                                **kw), SamplingParams, sched)
    assert tout == jout and tfree == jfree
    assert ti.counts == ji.counts == {s: 1 for _, s in plan}
    assert _counts(monitor) == _counts(jmon)
    if plan[0][1] == "decode.nan":
        assert sorted(o[1] for o in tout.values()) == ["length",
                                                       "nan_logits"]
    jeng.close()


def test_prefill_retry_budget_exhausts_to_failed():
    """A prefill that keeps failing burns its retry budget and lands in
    FAILED("error:prefill (...)"), pages balanced, as in the JAX
    engine."""
    jnet, tnet, _ = make_pair()
    kw = dict(max_slots=2, page_size=8, pool_pages=32, max_context=64,
              prefill_bucket=8)
    p = _prompts(np.random.default_rng(2), (6,))[0]
    outs = []
    for cls, net, params, inj in (
            (JaxEngine, jnet, JaxParams, jrel.FaultInjector(
                rate=1.0, sites=("prefill.device_error",))),
            (Engine, tnet, SamplingParams, FaultInjector(
                rate=1.0, sites=("prefill.device_error",)))):
        extra = {"device": "cpu"} if cls is Engine else {}
        eng = cls(net, fault_injector=inj, **kw, **extra)
        o = eng.run([(p, params(max_new_tokens=4))], max_steps=50)[0]
        outs.append((o.token_ids, o.finish_reason, o.error,
                     inj.counts, eng.pages_free == eng.pool_pages))
    assert outs[0] == outs[1]
    assert outs[1][1].startswith("error:prefill")
    assert outs[1][3] == {"prefill.device_error": 4}


def test_audit_repairs_injected_skew():
    """alloc.refcount_skew lands a stray reference on a live page every
    few steps; the per-step audit repairs it (serving.invariant_repairs
    counts it), the outputs are the clean run's and the pool balances."""
    _, tnet, _ = make_pair()
    kw = dict(max_slots=2, page_size=8, pool_pages=32, max_context=64,
              prefill_bucket=8)
    p = _prompts(np.random.default_rng(3), (6, 9))
    reqs = [(x, SamplingParams(max_new_tokens=8)) for x in p]
    clean = Engine(tnet, device="cpu", fault_injector=False, **kw).run(reqs)
    inj = FaultInjector(seed=5, rate=0.5, sites=("alloc.refcount_skew",))
    r0 = monitor.counter("serving.invariant_repairs").get()
    eng = Engine(tnet, device="cpu", fault_injector=inj, **kw)
    outs = eng.run(reqs)
    assert [o.token_ids for o in outs] == [o.token_ids for o in clean]
    assert inj.counts["alloc.refcount_skew"] > 0
    assert monitor.counter("serving.invariant_repairs").get() - r0 == \
        inj.counts["alloc.refcount_skew"]
    assert eng.pages_free == eng.pool_pages and eng.check_invariants() == []


# -- snapshot / restore ------------------------------------------------------

def _drain(eng, done, max_steps=200):
    for _ in range(max_steps):
        for o in eng.step():
            done[o.req_id] = o
        if eng.num_active == 0 and eng.num_waiting == 0 \
                and eng.num_prefilling == 0:
            break
    return done


@pytest.mark.parametrize("accel", ["prefix_spec", "mt8_chunked"])
def test_snapshot_restore_token_exact(accel):
    """Snapshot mid-flight — greedy AND seeded-sampling requests, one
    still queued — restore on a FRESH port engine, drain: every request
    emits the uninterrupted run's tokens (the sampled ones continue
    their generators exactly), with the prefix cache and speculation
    on, or with multi-tick and chunked prefill."""
    jnet, tnet, params = make_pair()
    rng = np.random.default_rng(4)
    shared = rng.integers(0, 64, (16,))
    prompts = [np.concatenate([shared, t]).astype(np.int64)
               for t in _prompts(rng, (5, 8, 3, 6))]
    cfgs = [dict(max_new_tokens=9),
            dict(max_new_tokens=8, temperature=0.9, seed=3),
            dict(max_new_tokens=7, temperature=1.1, top_k=6, top_p=0.9,
                 seed=11),
            dict(max_new_tokens=10)]
    if accel == "prefix_spec":
        _, td = _draft_of(jnet, params)
        kw = dict(prefix_cache=True, draft_model=td, spec_k=3)
    else:
        kw = dict(multi_tick=8, max_prefill_tokens_per_step=8)

    def mk():
        return Engine(tnet, device="cpu", max_slots=2, page_size=8,
                      pool_pages=64, max_context=64, prefill_bucket=8,
                      **kw)

    eng = mk()
    rids = [eng.add_request(p, SamplingParams(**c))
            for p, c in zip(prompts, cfgs)]
    sampled = [eng.requests[r] for r, c in zip(rids, cfgs)
               if c.get("temperature")]
    while not any(r.generated for r in sampled):      # mid-flight
        eng.step()
    assert eng.num_waiting and eng.num_active
    snap = json.loads(json.dumps(eng.snapshot()))     # a JSON round trip
    done_a = _drain(eng, {})
    eng_b = mk()
    assert eng_b.restore(snap) == len(snap["requests"])
    done_b = _drain(eng_b, {})
    assert set(done_b) == {e["req_id"] for e in snap["requests"]}
    assert any(e["torch_rng"] and e["generated"] for e in snap["requests"])
    for rid in done_b:
        assert done_b[rid].ok
        assert done_b[rid].token_ids == done_a[rid].token_ids, rid
    for e in (eng, eng_b):
        assert e.leaked_pages() == 0 and e.check_invariants() == []


def test_jax_greedy_snapshot_restores_in_port():
    """A greedy snapshot the JAX engine wrote (threefry keys, no torch
    state) restores on the port engine, which drains it to the JAX
    uninterrupted run's tokens."""
    jnet, tnet, _ = make_pair()
    kw = dict(max_slots=2, page_size=8, pool_pages=64, max_context=64,
              prefill_bucket=8)
    p = _prompts(np.random.default_rng(5), (5, 9, 4))
    jeng = JaxEngine(jnet, **kw)
    for x, n in zip(p, (10, 8, 9)):
        jeng.add_request(x, JaxParams(max_new_tokens=n))
    for _ in range(3):
        jeng.step()
    snap = json.loads(json.dumps(jeng.snapshot()))
    assert any(e["generated"] for e in snap["requests"])
    done_j = _drain(jeng, {})
    teng = Engine(tnet, device="cpu", **kw)
    assert teng.restore(snap) == len(snap["requests"])
    done_t = _drain(teng, {})
    assert set(done_t) == {e["req_id"] for e in snap["requests"]}
    for rid, o in done_t.items():
        assert o.token_ids == done_j[rid].token_ids, rid
    assert teng.leaked_pages() == 0
    jeng.close()


def test_snapshot_file_round_trip_and_validation(tmp_path):
    """snapshot_to / restore_from round-trip through an atomic JSON
    write; restore refuses a busy engine, a scheduler-geometry change
    (strict) and a token-incompatible model with the reference's
    messages; strict=False restores across geometries token-exactly; a
    bad version is refused; the fingerprint names the cache dtype as
    numpy does and equals the JAX engine's for the same model."""
    jnet, tnet, _ = make_pair()
    kw = dict(page_size=4, pool_pages=32, max_context=32, prefill_bucket=4,
              prefix_cache=True)
    eng = Engine(tnet, device="cpu", max_slots=2, **kw)
    jeng = JaxEngine(jnet, max_slots=2, **kw)
    assert trel._fingerprint(eng) == jrel._fingerprint(jeng)
    p = _prompts(np.random.default_rng(6), (9, 6))
    eng.add_request(p[0], SamplingParams(max_new_tokens=6))
    eng.add_request(p[1], SamplingParams(max_new_tokens=5,
                                         temperature=0.7, seed=2))
    for _ in range(2):
        eng.step()
    path = str(tmp_path / "snap.json")
    assert eng.snapshot_to(path) == path
    raw = trel.load_snapshot(path)
    assert raw["version"] == 1 and len(raw["requests"]) == 2
    assert raw["prefix_index"]
    assert raw["fingerprint"]["hard"]["cache_dtype"] == "float32"
    ent = {e["req_id"]: e for e in raw["requests"]}
    assert ent[0]["torch_rng"] is None and ent[0]["key"] == [0, 0]
    assert ent[1]["torch_rng_device"] == "cpu"
    with pytest.raises(RuntimeError, match="busy engine"):
        eng.restore(raw)
    done_a = _drain(eng, {})
    eng_b = Engine(tnet, device="cpu", max_slots=3, **kw)
    with pytest.raises(ValueError, match="scheduler geometry"):
        eng_b.restore(trel.load_snapshot(path))
    with pytest.warns(RuntimeWarning, match="scheduler geometries"):
        eng_b.restore_from(path, strict=False)
    done_b = _drain(eng_b, {})
    assert done_b and all(done_b[r].token_ids == done_a[r].token_ids
                          for r in done_b)
    _, other, _ = make_pair(vocab=32)
    eng_c = Engine(other, device="cpu", max_slots=2, **kw)
    with pytest.raises(ValueError, match="token-incompatible"):
        eng_c.restore(trel.load_snapshot(path), strict=False)
    bad = trel.load_snapshot(path)
    bad["version"] = 99
    with pytest.raises(ValueError, match="version"):
        Engine(tnet, device="cpu", max_slots=2, **kw).restore(bad)
    assert trel.save_snapshot(raw, str(tmp_path / "again.json"))
    assert trel.load_snapshot(str(tmp_path / "again.json")) == raw
    assert not list(tmp_path.glob("*.tmp.*"))
    jeng.close()


def test_restore_refuses_sampled_request_without_torch_rng():
    """A sampled request that already emitted tokens cannot continue its
    stream without its generator state of the serving device's type:
    restore raises ValueError and leaves the engine untouched; the same
    request before its first token restores from its seed."""
    _, tnet, _ = make_pair()
    kw = dict(max_slots=2, page_size=8, pool_pages=32, max_context=64)
    eng = Engine(tnet, device="cpu", **kw)
    p = _prompts(np.random.default_rng(7), (5,))[0]
    eng.add_request(p, SamplingParams(max_new_tokens=8, temperature=0.8,
                                      seed=4))
    untouched = eng.snapshot()
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    for field, value in (("torch_rng", None), ("torch_rng_device", "cuda")):
        bad = json.loads(json.dumps(snap))
        bad["requests"][0][field] = value
        fresh = Engine(tnet, device="cpu", **kw)
        with pytest.raises(ValueError, match="torch_rng"):
            fresh.restore(bad)
        assert not fresh.requests and not fresh.num_waiting
    alone = Engine(tnet, device="cpu", **kw).run(
        [(p, SamplingParams(max_new_tokens=8, temperature=0.8, seed=4))])
    untouched["requests"][0]["torch_rng"] = None
    eng_b = Engine(tnet, device="cpu", **kw)
    eng_b.restore(untouched)
    assert _drain(eng_b, {})[0].token_ids == alone[0].token_ids


def test_restore_resets_live_requests_queue_budget():
    """A request RUNNING at snapshot time re-enters the restored queue
    with a fresh max_queue_steps budget and finishes with the
    uninterrupted tokens (not a spurious queue_timeout)."""
    _, tnet, _ = make_pair()
    kw = dict(max_slots=2, page_size=8, pool_pages=32, max_context=64,
              prefill_bucket=8)
    p = _prompts(np.random.default_rng(8), (5,))[0]
    want = Engine(tnet, device="cpu", **kw).run(
        [(p, SamplingParams(max_new_tokens=12))])[0].token_ids
    eng = Engine(tnet, device="cpu", **kw)
    eng.add_request(p, SamplingParams(max_new_tokens=12, max_queue_steps=3))
    for _ in range(6):
        eng.step()
    eng_b = Engine(tnet, device="cpu", **kw)
    eng_b.restore(eng.snapshot())
    out = _drain(eng_b, {})[0]
    assert out.ok and out.token_ids == want


# -- flags and the watchdog --------------------------------------------------

def test_flags_arm_injector_and_debug_audit():
    """FLAGS_serving_fault_* arm an injector at construction,
    fault_injector=False forces it off in a flag-armed process, and the
    debug audit raises on a planted refcount skew."""
    _, tnet, _ = make_pair()
    kw = dict(max_slots=2, page_size=8, pool_pages=16, max_context=32,
              prefill_bucket=8)
    flags.set_flags({"FLAGS_serving_fault_seed": 42,
                     "serving_fault_rate": "0.0",
                     "serving_fault_sites": "decode.nan"})
    try:
        eng = Engine(tnet, device="cpu", **kw)
        assert eng._injector is not None and eng._injector.seed == 42
        assert eng._injector.sites == {"decode.nan"}
        assert eng._injector.rate == 0.0
        assert Engine(tnet, device="cpu", fault_injector=False,
                      **kw)._injector is None
    finally:
        flags.set_flags({"serving_fault_seed": -1,
                         "serving_fault_rate": 0.02,
                         "serving_fault_sites": ""})
    assert Engine(tnet, device="cpu", **kw)._injector is None
    with pytest.raises(ValueError, match="not registered"):
        flags.get_flag("serving_no_such_flag")
    eng2 = Engine(tnet, device="cpu", debug_invariants=True, **kw)
    eng2.add_request(_prompts(np.random.default_rng(9), (5,))[0],
                     SamplingParams(max_new_tokens=6))
    eng2.step()
    req = next(iter(eng2.requests.values()))
    eng2._alloc.share(req.pages[0])
    with pytest.raises(RuntimeError, match="invariant audit failed"):
        eng2.step()


def test_heartbeat_stall_writes_snapshot(tmp_path, monkeypatch):
    """run(heartbeat_timeout=...) with a step patched to stall: the
    watcher fires once, counts serving.stalls and writes a loadable
    snapshot to snapshot_path; the run still drains."""
    _, tnet, _ = make_pair()
    eng = Engine(tnet, device="cpu", max_slots=2, page_size=8,
                 pool_pages=32, max_context=64)
    real = eng.step
    calls = {"n": 0}

    def slow_step():
        calls["n"] += 1
        if calls["n"] == 2:
            time.sleep(0.6)
        return real()

    monkeypatch.setattr(eng, "step", slow_step)
    s0 = monitor.counter("serving.stalls").get()
    path = str(tmp_path / "stall.json")
    p = _prompts(np.random.default_rng(10), (5, 7))
    outs = eng.run([(x, SamplingParams(max_new_tokens=6)) for x in p],
                   heartbeat_timeout=0.2, snapshot_path=path)
    assert all(o.ok for o in outs)
    assert monitor.counter("serving.stalls").get() - s0 >= 1
    snap = trel.load_snapshot(path)
    assert snap["version"] == 1 and snap["requests"]
    assert eng.last_stall_snapshot is not None
