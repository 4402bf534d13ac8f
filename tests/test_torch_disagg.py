"""The port's disaggregated serving (``paddle_tpu_torch.inference.disagg``)
on the CPU.

The contract: splitting the loop into prefill and decode workers, with
KV pages migrating between their pools, changes no token. Greedy streams
equal the JAX ``DisaggEngine``'s on the same weights (``bridge.py``);
greedy and seeded-sampling streams equal the port's single-loop
``Engine``'s through prefix hits across the migration, speculative
decoding, decode-pool preemption, a mid-migration preemption, worker
kills (by call and by the ``worker.die_*`` fault sites) and multi-tick
decode workers; ``replay_rng_key`` is the live generator's state after n
tokens; snapshots taken with requests MIGRATING restore token-exact, and
so does a greedy snapshot the JAX driver wrote. No page leaks. Sampled
tokens are not compared across frameworks (threefry is not reproduced).

Tolerance: exact tokens.
"""
import asyncio
import json

import numpy as np
import pytest
import torch

from paddle_tpu.inference.disagg import DisaggEngine as JaxDisagg
from paddle_tpu.inference.engine import SamplingParams as JaxParams
from paddle_tpu_torch import monitor
from paddle_tpu_torch.inference import (DisaggEngine, Engine, FaultInjector,
                                        FaultPlan, SamplingParams)
from paddle_tpu_torch.inference import disagg
from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

from test_torch_engine import _prompts, _tiny, torch_one_thread  # noqa: F401
from test_torch_llama import make_pair

pytestmark = pytest.mark.usefixtures("torch_one_thread")

KW = dict(page_size=4, max_context=48, prefill_bucket=4, device="cpu")


def _draft(seed=7):
    cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=4)
    return LlamaForCausalLM(cfg, device="cpu", seed=seed, init_std=0.2)


def _mixed(seed=0, lens=(6, 4, 11, 5, 9, 7)):
    """Alternately greedy and seeded-sampling requests."""
    rng = np.random.default_rng(seed)
    out = []
    for i, p in enumerate(_prompts(rng, lens)):
        sampled = i % 2 == 1
        out.append((p, dict(max_new_tokens=6 + i,
                            temperature=0.9 if sampled else 0.0,
                            top_k=8 if sampled else 0, seed=30 + i)))
    return out


def _reference(net, requests, **kw):
    eng = Engine(net, max_slots=4, **dict(KW, **kw))
    return {o.req_id: o.token_ids for o in eng.run(
        [(p, SamplingParams(**c)) for p, c in requests])}


def _drain(eng, done=None, max_steps=400, each=None):
    done = {} if done is None else done
    for step in range(max_steps):
        for o in eng.step():
            assert o.ok, o
            done[o.req_id] = o.token_ids
        if each is not None:
            each(step)
        if eng.idle:
            break
    assert eng.idle
    return done


def _drained(eng):
    for w in eng.prefill + eng.decode:
        if w is not None:
            assert all(r is None for r in w._slots)
    assert eng.num_waiting == 0 and eng.num_migrating == 0
    assert eng.leaked_pages() == 0
    assert eng.check_invariants() == []


def test_greedy_streams_match_jax_disagg_staggered():
    jnet, tnet, _ = make_pair(hidden=32, heads=4)
    rng = np.random.default_rng(1)
    p = _prompts(rng, (5, 9, 3, 7))
    kw = dict(prefill_workers=2, decode_workers=2, max_slots=2, page_size=8,
              pool_pages=64, max_context=64)
    got = {}
    for eng, params in ((JaxDisagg(jnet, **kw), JaxParams),
                        (DisaggEngine(tnet, device="cpu", **kw),
                         SamplingParams)):
        done = {}
        for q, n in zip(p[:2], (8, 6)):
            eng.add_request(q, params(max_new_tokens=n))
        for _ in range(3):
            done.update({o.req_id: o.token_ids for o in eng.step()})
        for q, n in zip(p[2:], (8, 5)):
            eng.add_request(q, params(max_new_tokens=n))
        for _ in range(80):
            done.update({o.req_id: o.token_ids for o in eng.step()})
            if len(done) == 4:
                break
        got[type(eng).__module__] = done
        assert eng.leaked_pages() == 0
        eng.close()
    jax_done, port_done = got.values()
    assert port_done == jax_done and len(port_done) == 4


#: driver geometries held to the single-loop Engine: (engine kwargs of
#: both, driver-only kwargs, reference-only kwargs)
CASES = {
    "mixed_1p2d": (dict(pool_pages=64), dict(prefill_workers=1,
                                             decode_workers=2,
                                             max_slots=2), {}),
    "multi_tick_2": (dict(pool_pages=64), dict(prefill_workers=2,
                                               decode_workers=1,
                                               max_slots=3,
                                               multi_tick=2), {}),
    "prefix_hits": (dict(pool_pages=64, prefix_cache=True),
                    dict(prefill_workers=1, decode_workers=2, max_slots=2),
                    {}),
    "speculative": (dict(pool_pages=64, spec_k=3),
                    dict(prefill_workers=1, decode_workers=2, max_slots=2),
                    {}),
    "decode_preemption": (dict(watermark_pages=0),
                          dict(prefill_workers=1, decode_workers=1,
                               max_slots=2, pool_pages=4,
                               prefill_pool_pages=8),
                          dict(pool_pages=64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_match_the_single_loop_engine(case):
    both, drv, ref_only = CASES[case]
    net = _tiny(seed=2)
    if "spec_k" in both:
        both = dict(both, draft_model=_draft())
    # two requests that outgrow the 4-page decode pool together
    requests = _mixed(seed=3, lens=(4, 3) if case == "decode_preemption"
                      else (6, 4, 11, 5, 9, 7))
    if case == "multi_tick_2":
        # one sampled request: greedy stretches fuse before and after it
        requests = [(p, c if i == 1 else dict(c, temperature=0.0, top_k=0))
                    for i, (p, c) in enumerate(requests)]
    if case == "prefix_hits":
        system = np.random.default_rng(4).integers(0, 64, (12,))
        requests = [(np.concatenate([system, p]).astype(np.int32), c)
                    for p, c in requests]
    ref = _reference(net, requests, **dict(both, **ref_only))
    p0 = monitor.counter("serving.preemptions").get()
    m0 = monitor.counter("serving.disagg.migrations").get()
    f0 = monitor.counter("serving.multi_tick.dispatches").get()
    eng = DisaggEngine(net, **KW, **both, **drv)
    outs = eng.run([(p, SamplingParams(**c)) for p, c in requests])
    assert {o.req_id: o.token_ids for o in outs} == ref
    assert monitor.counter("serving.disagg.migrations").get() - m0 \
        >= len(requests)
    if case == "prefix_hits":
        assert eng.prefix_hit_rate > 0
    if case == "speculative":
        assert eng.spec_accept_rate > 0
    if case == "decode_preemption":
        assert monitor.counter("serving.preemptions").get() > p0
    if case == "multi_tick_2":
        assert monitor.counter("serving.multi_tick.dispatches").get() > f0
    _drained(eng)


def test_mid_migration_preemption():
    """A request parked MIGRATING (the one decode slot busy) is preempted,
    its prefill-side pages freed at once, and still finishes token-exact
    after its re-prefill."""
    net = _tiny(seed=5)
    requests = _mixed(seed=6, lens=(5, 6, 4))
    ref = _reference(net, requests, pool_pages=64)
    eng = DisaggEngine(net, prefill_workers=1, decode_workers=1,
                       max_slots=1, pool_pages=32, **KW)
    for p, c in requests:
        eng.add_request(p, SamplingParams(**c))
    parked = []

    def each(step):
        if not parked and eng.num_migrating:
            rid = eng._ready[0][1].req_id
            pw = eng.prefill[0]
            free0 = pw.pages_free
            assert eng.preempt_migrating(rid)
            assert pw.pages_free > free0
            assert not eng.preempt_migrating(rid)
            parked.append(rid)
    c0 = monitor.counter("serving.disagg.migration_preempts").get()
    done = _drain(eng, each=each)
    assert parked
    assert monitor.counter("serving.disagg.migration_preempts").get() > c0
    assert done == ref
    _drained(eng)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_worker_kills_readmit_token_exact(spec):
    """A decode worker holding live greedy and sampled requests dies, then
    a prefill worker: every request re-admits from host truth (a replayed
    generator; the dead worker's is never read) and finishes token-exact,
    speculative requests included. The last worker of a kind stays."""
    net = _tiny(seed=6)
    extra = dict(draft_model=_draft(), spec_k=3) if spec else {}
    requests = _mixed(seed=7, lens=(5, 8, 4, 6, 7, 9))
    ref = _reference(net, requests, pool_pages=64, **extra)
    eng = DisaggEngine(net, prefill_workers=2, decode_workers=2,
                       max_slots=2, pool_pages=64, **KW, **extra)
    for p, c in requests:
        eng.add_request(p, SamplingParams(**c))
    k0 = monitor.counter("serving.disagg.worker_kills").get()
    killed = []

    def each(step):
        if killed or not eng.num_active:
            return
        loads = [(w.num_active, i) for i, w in enumerate(eng.decode)]
        victim = max(loads)[1]
        doomed = dict(eng.decode[victim].requests)
        old = {rid: r.generator for rid, r in doomed.items()}
        assert eng.kill_worker("decode", victim) == len(doomed) > 0
        assert any(r.params.temperature > 0 and r.generated
                   for r in doomed.values())
        assert all(r.generator is not old[rid]
                   for rid, r in doomed.items())
        assert eng.decode[victim] is None
        assert eng.kill_worker("decode", victim) == 0      # already gone
        eng.kill_worker("prefill", 0)
        killed.append(victim)
    done = _drain(eng, each=each)
    assert killed and done == ref
    assert monitor.counter("serving.disagg.worker_kills").get() - k0 == 2
    with pytest.raises(RuntimeError, match="last"):
        eng.kill_worker("prefill", 1)
    assert eng.utilization()[f"decode{killed[0]}"]["alive"] is False
    _drained(eng)


def test_worker_die_fault_sites_kill_and_stay_exact():
    """The seeded ``worker.die_prefill`` / ``worker.die_decode`` sites
    (a FaultPlan) kill a worker of each kind; the Engine never queries
    them, so only the driver's draws move; tokens stay exact."""
    net = _tiny(seed=8)
    requests = _mixed(seed=9)
    ref = _reference(net, requests, pool_pages=64)
    inj = FaultInjector(seed=3, rate=0.0, plan=FaultPlan.parse(
        "3:worker.die_decode, 5:worker.die_prefill"))
    eng = DisaggEngine(net, prefill_workers=2, decode_workers=2,
                       max_slots=2, pool_pages=64, fault_injector=inj, **KW)
    outs = eng.run([(p, SamplingParams(**c)) for p, c in requests])
    assert {o.req_id: o.token_ids for o in outs} == ref
    assert inj.counts == {"worker.die_decode": 1, "worker.die_prefill": 1}
    assert sum(w is None for w in eng.prefill + eng.decode) == 2
    _drained(eng)


@pytest.mark.parametrize("temperature", [0.0, 0.8],
                         ids=["greedy", "sampled"])
def test_replay_rng_key_matches_the_live_generator(temperature):
    net = _tiny()
    eng = Engine(net, max_slots=1, page_size=4, max_context=32,
                 device="cpu")
    rid = eng.add_request([1, 2, 3, 4, 5], SamplingParams(
        max_new_tokens=9, temperature=temperature, top_k=8, seed=11))
    req = eng.requests[rid]
    for _ in range(5):
        eng.step()
    n = len(req.generated)
    assert n >= 4
    got = disagg.replay_rng_key(11, n, temperature, vocab_size=64,
                                device="cpu")
    assert torch.equal(got, req.generator.get_state())
    fresh = torch.Generator().manual_seed(11).get_state()
    assert torch.equal(disagg.replay_rng_key(11, n, 0.0, vocab_size=64,
                                             device="cpu"), fresh)
    assert torch.equal(got, fresh) == (temperature == 0.0)


def test_snapshot_restore_with_requests_migrating():
    """A snapshot taken while a request is MIGRATING (the decode slot
    busy) restores on a fresh driver of another topology token-exact,
    seeded sampling included; a busy driver and a foreign snapshot are
    refused."""
    net = _tiny(seed=10)
    requests = _mixed(seed=11, lens=(5, 7, 6))
    ref = _reference(net, requests, pool_pages=64)
    eng = DisaggEngine(net, prefill_workers=1, decode_workers=1,
                       max_slots=1, pool_pages=32, **KW)
    for p, c in requests:
        eng.add_request(p, SamplingParams(**c))
    snap = None
    for _ in range(40):
        eng.step()
        if eng.num_migrating and any(
                r.generated for r in eng.requests.values()
                if r.params.temperature > 0):
            snap = json.loads(json.dumps(eng.snapshot()))
            break
    assert snap is not None and snap["kind"] == "disagg"
    assert len(snap["requests"]) == len(requests)
    with pytest.raises(RuntimeError, match="busy"):
        eng.restore(snap)
    fresh = DisaggEngine(net, prefill_workers=2, decode_workers=1,
                         max_slots=2, pool_pages=32, **KW)
    with pytest.raises(ValueError, match="not a disagg"):
        fresh.restore(dict(snap, kind="fleet"))
    assert fresh.restore(snap) == len(requests)
    assert _drain(fresh) == ref
    _drained(fresh)


def test_jax_greedy_snapshot_restores_in_the_port():
    """A greedy snapshot written by the JAX driver mid-run (one request
    parked MIGRATING) restores in the port token-exact; the JAX run,
    finished, is the reference."""
    jnet, tnet, _ = make_pair(hidden=32, heads=4)
    rng = np.random.default_rng(12)
    p = _prompts(rng, (5, 7, 6))
    kw = dict(prefill_workers=1, decode_workers=1, max_slots=1, page_size=8,
              pool_pages=32, max_context=64)
    jeng = JaxDisagg(jnet, **kw)
    for q, n in zip(p, (8, 6, 7)):
        jeng.add_request(q, JaxParams(max_new_tokens=n))
    snap, done = None, {}
    for _ in range(80):
        done.update({o.req_id: o.token_ids for o in jeng.step()})
        if snap is None and jeng.num_migrating:
            snap = json.loads(json.dumps(jeng.snapshot()))
        if len(done) == 3:
            break
    jeng.close()
    assert snap is not None and len(done) == 3
    assert any(e["generated"] for e in snap["requests"])
    port = DisaggEngine(tnet, device="cpu", **kw)
    assert port.restore(snap) == len(snap["requests"])
    got = _drain(port)
    assert got == {e["req_id"]: done[e["req_id"]] for e in snap["requests"]}


def test_tenant_fairness():
    """One request of a second tenant, queued behind a flood of eight,
    finishes among the first three."""
    net = _tiny()
    rng = np.random.default_rng(13)
    eng = DisaggEngine(net, prefill_workers=1, decode_workers=1,
                       max_slots=2, pool_pages=64, **KW)
    for p in _prompts(rng, (6,) * 8):
        eng.add_request(p, SamplingParams(max_new_tokens=8), tenant="flood")
    vip = eng.add_request(_prompts(rng, (5,))[0],
                          SamplingParams(max_new_tokens=4), tenant="vip")
    order = []
    for _ in range(200):
        order += [o.req_id for o in eng.step()]
        if len(order) == 9:
            break
    assert len(order) == 9 and order.index(vip) <= 2


def test_streaming_front_door():
    net = _tiny(seed=14)
    requests = _mixed(seed=15, lens=(5, 7))
    ref = _reference(net, requests, pool_pages=64)
    eng = DisaggEngine(net, prefill_workers=1, decode_workers=1,
                       max_slots=2, pool_pages=64, **KW)
    rid = eng.add_request(requests[0][0], SamplingParams(**requests[0][1]))
    assert list(eng.stream(rid)) == ref[0]
    r0, r1 = (eng.add_request(p, SamplingParams(**c)) for p, c in requests)

    async def consume(r):
        return [t async for t in eng.astream(r)]

    async def both():
        return await asyncio.gather(consume(r0), consume(r1))
    t0, t1 = asyncio.run(both())
    assert (t0, t1) == (ref[0], ref[1])
    with pytest.raises(KeyError):
        list(eng.stream(999))
    assert eng.cancel(r0) is None                   # retired already
    rid = eng.add_request([1, 2, 3], SamplingParams(max_new_tokens=5))
    out = eng.cancel(rid)
    assert out.finish_reason == "cancelled" and not out.ok
    _drained(eng)


def test_validates_requests_and_refusals():
    net = _tiny()
    eng = DisaggEngine(net, prefill_workers=1, decode_workers=1,
                       max_slots=2, page_size=8, pool_pages=3,
                       prefill_pool_pages=8, max_context=32, device="cpu")
    with pytest.raises(ValueError, match="max_context"):
        eng.add_request(np.arange(30) % 64, SamplingParams(max_new_tokens=30))
    with pytest.raises(RuntimeError, match="never be scheduled"):
        eng.add_request(np.arange(8), SamplingParams(max_new_tokens=20))
    with pytest.raises(ValueError, match="ONE prompt"):
        eng.add_request(np.zeros((2, 4), np.int64))
    with pytest.raises(ValueError):
        DisaggEngine(net, prefill_workers=0, decode_workers=1, device="cpu")
    with pytest.raises(ValueError, match="kind"):
        eng.kill_worker("prefil", 0)
    with pytest.raises(ValueError, match="out of range"):
        eng.kill_worker("decode", -1)
    # what stays for ROADMAP items 6 (analysis) and 3 (the Engine on ranks)
    for call in (eng.steady_state_recompiles, eng.inspect_hotpath,
                 lambda: disagg.lint_migration(2, 6, 4, 8, 16)):
        with pytest.raises(NotImplementedError, match="item 6"):
            call()
    with pytest.raises(NotImplementedError, match="item 3"):
        disagg.migration_collective([], 2, 0, 1, group=object())
    block = [(torch.ones(2),)]
    assert disagg.migration_collective(block, 2, 0, 1) is block
    with pytest.raises(NotImplementedError, match="item 3"):
        DisaggEngine.from_plan(net, {"prefill_workers": 1,
                                     "decode_workers": 1, "decode_mp": 2},
                               device="cpu")
    planned = DisaggEngine.from_plan(net, {"prefill_workers": 2,
                                           "decode_workers": 1},
                                     device="cpu", max_context=32)
    assert (len(planned.prefill), len(planned.decode)) == (2, 1)
