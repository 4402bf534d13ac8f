"""The port's serving fleet (``paddle_tpu_torch.inference.fleet``) on the
CPU.

The contract: N whole Engine replicas behind one front door change no
token. Greedy streams equal the JAX ``ServingFleet``'s on the same
weights (``bridge.py``); greedy and seeded-sampling streams equal the
port's single-loop ``Engine``'s through routing, live migration (mid
decode and mid prefill, with prefix hits, speculative decoding and
pool-pressure preemption on the target), ``kill_replica`` and the
``replica.die`` fault site, heartbeat-stall failover, autoscaling up and
down, drain / undrain and snapshots of parked requests. Session routing
beats round robin on the fleet-wide prefix hit rate, as JAX's
``test_session_routing_beats_round_robin`` holds. No page leaks.

Tolerance: exact tokens.
"""
import json
import time

import numpy as np
import pytest

from paddle_tpu.inference.engine import SamplingParams as JaxParams
from paddle_tpu.inference.fleet import ServingFleet as JaxFleet
from paddle_tpu_torch import monitor
from paddle_tpu_torch.inference import (AutoscalePolicy, Engine,
                                        FaultInjector, FaultPlan,
                                        SamplingParams, ServingFleet)

from test_torch_disagg import _draft, _mixed
from test_torch_engine import _prompts, _tiny, torch_one_thread  # noqa: F401
from test_torch_llama import make_pair

pytestmark = pytest.mark.usefixtures("torch_one_thread")

KW = dict(max_slots=2, page_size=4, max_context=48, prefill_bucket=4,
          pool_pages=64, device="cpu")


def _reference(net, requests, **kw):
    eng = Engine(net, **dict(KW, max_slots=4, **kw))
    return {o.req_id: o.token_ids for o in eng.run(
        [(p, SamplingParams(**c)) for p, c in requests])}


def _drain(fleet, done=None, max_steps=600, each=None):
    done = {} if done is None else done
    for step in range(max_steps):
        for o in fleet.step():
            assert o.ok, o
            done[o.req_id] = o.token_ids
        if each is not None:
            each(step)
        if fleet.idle:
            break
    assert fleet.idle
    return done


def _clean(fleet):
    assert fleet.num_waiting == 0 and fleet.num_parked == 0
    assert fleet.leaked_pages() == 0
    assert fleet.check_invariants() == []


def test_greedy_streams_match_jax_fleet():
    jnet, tnet, _ = make_pair(hidden=32, heads=4)
    rng = np.random.default_rng(1)
    p = _prompts(rng, (5, 9, 3, 7, 6))
    kw = dict(replicas=2, max_slots=2, page_size=8, pool_pages=64,
              max_context=64)
    jf = JaxFleet(jnet, **kw)
    jout = jf.run([(q, JaxParams(max_new_tokens=6 + i))
                   for i, q in enumerate(p)])
    jf.close()
    tf = ServingFleet(tnet, device="cpu", **kw)
    tout = tf.run([(q, SamplingParams(max_new_tokens=6 + i))
                   for i, q in enumerate(p)])
    assert [o.token_ids for o in tout] == [o.token_ids for o in jout]
    assert [o.req_id for o in tout] == [o.req_id for o in jout]
    _clean(tf)


def test_fleet_matches_the_single_loop_engine_mixed_sampling():
    net = _tiny(seed=2)
    requests = _mixed(seed=3)
    ref = _reference(net, requests)
    fleet = ServingFleet(net, replicas=2, **KW)
    outs = fleet.run([(p, SamplingParams(**c)) for p, c in requests])
    assert {o.req_id: o.token_ids for o in outs} == ref
    assert all(st["finished"] for st in fleet.replica_stats.values())
    _clean(fleet)


@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_migration_mid_flight_is_exact(phase):
    """Live migration mid decode (greedy and sampled) or mid chunked
    prefill: the source's slot and pages free at once, the generator is
    replayed (not carried), and the stream is the never-migrated one."""
    net = _tiny(seed=4)
    extra = ({"max_prefill_tokens_per_step": 4} if phase == "prefill"
             else {})
    requests = _mixed(seed=5, lens=(6, 8, 13, 11))
    ref = _reference(net, requests, **extra)
    fleet = ServingFleet(net, replicas=2, **KW, **extra)
    rids = [fleet.add_request(p, SamplingParams(**c)) for p, c in requests]
    moved = {}
    m0 = monitor.counter("serving.fleet.migrations").get()

    def each(step):
        for rid in rids:
            req = fleet.requests.get(rid)
            home = fleet._home.get(rid)
            if rid in moved or req is None or home is None \
                    or req.slot is None:
                continue
            live = bool(req.generated) if phase == "decode" \
                else (not req.generated and req.written > 0)
            if not live:
                continue
            gen = req.generator
            src = fleet._replicas[home]
            free0 = src.pages_free
            assert fleet.migrate_request(rid, dst=1 - home)
            assert req.generator is not gen and req.slot is None
            assert src.pages_free > free0 and rid not in src.requests
            assert fleet.num_parked >= 1
            moved[rid] = req.params.temperature
    done = _drain(fleet, each=each)
    assert moved
    if phase == "decode":
        assert {t > 0 for t in moved.values()} == {True, False}
    assert done == ref
    assert monitor.counter("serving.fleet.migrations").get() - m0 \
        == len(moved)
    assert not fleet.migrate_request(rids[0])        # retired
    _clean(fleet)


def test_spec_prefix_preempt_migration_exact():
    """Prefix hits, speculative decoding and seeded sampling on, a
    request migrated mid decode, the pools tight enough that the target
    preempts: the streams stay the uninterrupted run's."""
    net = _tiny(seed=6)
    draft = _draft()
    system = np.random.default_rng(7).integers(0, 64, (8,))
    requests = [(np.concatenate([system, p]).astype(np.int32), c)
                for p, c in _mixed(seed=8, lens=(4, 5, 6, 7, 8))]
    ref = _reference(net, requests, draft_model=draft, spec_k=3,
                     prefix_cache=True)
    p0 = monitor.counter("serving.preemptions").get()
    fleet = ServingFleet(net, replicas=2, **dict(KW, pool_pages=12),
                         draft_model=draft, spec_k=3)
    rids = [fleet.add_request(p, SamplingParams(**c)) for p, c in requests]
    moved = []

    def each(step):
        if moved:
            return
        for rid in rids:
            req = fleet.requests.get(rid)
            if req is not None and req.generated \
                    and req.params.temperature > 0 \
                    and fleet._home.get(rid) is not None:
                assert fleet.migrate_request(rid)
                moved.append(rid)
                return
    done = _drain(fleet, each=each)
    assert moved and done == ref
    assert monitor.counter("serving.preemptions").get() - p0 >= 2
    assert fleet.prefix_hit_rate > 0 and fleet.spec_accept_rate > 0
    _clean(fleet)


@pytest.mark.parametrize("how", ["call", "fault_site"])
def test_kill_replica_failover_exact(how):
    net = _tiny(seed=9)
    requests = _mixed(seed=10)
    ref = _reference(net, requests)
    inj = None
    if how == "fault_site":
        inj = FaultInjector(seed=1, rate=0.0,
                            plan=FaultPlan.parse("3:replica.die"))
    fleet = ServingFleet(net, replicas=2, fault_injector=inj, **KW)
    for p, c in requests:
        fleet.add_request(p, SamplingParams(**c))
    d0 = monitor.counter("serving.fleet.replica_deaths").get()

    def each(step):
        if how == "call" and step == 3:
            assert fleet.kill_replica(1) >= 1
            assert fleet.num_replicas == 1
            assert fleet.kill_replica(1) == 0
    done = _drain(fleet, each=each)
    assert done == ref and fleet.num_replicas == 1
    assert monitor.counter("serving.fleet.replica_deaths").get() - d0 == 1
    if inj is not None:
        assert inj.counts == {"replica.die": 1}
    with pytest.raises(RuntimeError, match="last replica"):
        fleet.kill_replica(fleet._alive()[0][0])
    assert fleet.utilization()["replica1" if how == "call" else
                               f"replica{1 - fleet._alive()[0][0]}"][
        "alive"] is False
    _clean(fleet)


def test_heartbeat_stall_failover():
    """A replica whose heartbeat stops while the driver keeps stepping is
    killed and failed over, token-exact; a paused DRIVER (every heartbeat
    aged out together) kills nothing."""
    net = _tiny(seed=11)
    requests = [(p, dict(c, max_new_tokens=20))
                for p, c in _mixed(seed=12, lens=(5, 7, 6, 8))]
    ref = _reference(net, requests)
    fleet = ServingFleet(net, replicas=2, heartbeat_timeout=0.15, **KW)
    for p, c in requests:
        fleet.add_request(p, SamplingParams(**c))
    done = {}
    for _ in range(2):
        done.update({o.req_id: o.token_ids for o in fleet.step()})
    time.sleep(0.5)                       # the driver pauses
    done.update({o.req_id: o.token_ids for o in fleet.step()})
    assert fleet.num_replicas == 2
    fleet._heartbeats[1].tick = lambda: None         # replica 1 wedges
    deadline = time.time() + 15.0
    while fleet.num_replicas == 2 and time.time() < deadline:
        done.update({o.req_id: o.token_ids for o in fleet.step()})
        time.sleep(0.02)
    assert fleet.num_replicas == 1
    assert _drain(fleet, done) == ref
    fleet.close()
    _clean(fleet)


def test_dropped_fleet_with_heartbeats_is_collected():
    """A fleet with heartbeats that is dropped without ``close()`` is
    collected: its watcher threads hold it only weakly, and its
    ``__del__`` stops them, so its replicas' pools go with it."""
    import gc
    import weakref
    fleet = ServingFleet(_tiny(seed=13), replicas=2, heartbeat_timeout=30.0,
                         **KW)
    beats = list(fleet._heartbeats.values())
    assert all(hb.alive for hb in beats)
    ref = weakref.ref(fleet)
    del fleet
    gc.collect()
    assert ref() is None
    assert not any(hb.alive for hb in beats)


def test_autoscale_up_and_down_drops_nothing():
    """Queue pressure on the injectable clock's steps adds a replica;
    sustained low load drains one back by migration; every request
    finishes token-exact and both events are logged and counted."""
    net = _tiny(seed=13)
    requests = _mixed(seed=14)
    ref = _reference(net, requests)
    c0 = monitor.counter("serving.fleet.scale_events").get()
    vt = {"t": 0.0}
    fleet = ServingFleet(
        net, replicas=1, clock=lambda: vt["t"],
        autoscale=AutoscalePolicy(min_replicas=1, max_replicas=2,
                                  scale_up_queue_depth=2, patience=1,
                                  scale_down_patience=3, cooldown=2,
                                  scale_up_ttft_p95_ms=1e9), **KW)
    for p, c in requests:
        fleet.add_request(p, SamplingParams(**c))
    done = {}
    for _ in range(400):
        done.update({o.req_id: o.token_ids for o in fleet.step()})
        vt["t"] += 0.005
        if len(done) == len(requests) and fleet.num_replicas == 1:
            break
    assert done == ref
    assert [e["action"] for e in fleet.scale_log][:1] == ["up"]
    assert "down" in [e["action"] for e in fleet.scale_log]
    assert monitor.counter("serving.fleet.scale_events").get() - c0 >= 2
    _clean(fleet)
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=0)
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=3, max_replicas=2)


def test_drain_and_undrain():
    net = _tiny(seed=15)
    requests = [(p, dict(c, max_new_tokens=8))
                for p, c in _mixed(seed=16, lens=(5, 7, 6, 8))]
    ref = _reference(net, requests)
    fleet = ServingFleet(net, replicas=2, **KW)
    for p, c in requests[:2]:
        fleet.add_request(p, SamplingParams(**c))
    done = {}
    for _ in range(2):
        done.update({o.req_id: o.token_ids for o in fleet.step()})
    loaded = next(i for i, w in fleet._alive() if w.requests)
    assert fleet.drain_replica(loaded) >= 1
    assert not fleet._replicas[loaded].requests
    for p, c in requests[2:]:
        fleet.add_request(p, SamplingParams(**c))

    def each(step):
        assert not fleet._replicas[loaded].requests
    done = _drain(fleet, done, each=each)
    assert done == ref
    fleet.undrain_replica(loaded)
    before = fleet.replica_stats[loaded]["routed_cold"] \
        + fleet.replica_stats[loaded]["routed_warm"]
    # fresh prompts (no warm replica): the undrained one takes work again
    for p in _prompts(np.random.default_rng(21), (6, 5, 7, 4)):
        fleet.add_request(p, SamplingParams(max_new_tokens=4))
    _drain(fleet)
    assert fleet.replica_stats[loaded]["routed_cold"] \
        + fleet.replica_stats[loaded]["routed_warm"] > before
    with pytest.raises(ValueError, match="no live replica"):
        fleet.drain_replica(7)
    _clean(fleet)


def test_parked_snapshot_restores_token_exact():
    net = _tiny(seed=17)
    requests = _mixed(seed=18, lens=(5, 9, 3))
    ref = _reference(net, requests)
    fleet = ServingFleet(net, replicas=2, **KW)
    rids = [fleet.add_request(p, SamplingParams(**c)) for p, c in requests]
    for _ in range(3):
        fleet.step()
    victim = next(rid for rid in rids
                  if fleet.requests[rid].generated
                  and fleet.requests[rid].params.temperature > 0)
    assert fleet.migrate_request(victim)
    snap = json.loads(json.dumps(fleet.snapshot()))
    assert [e["req_id"] for e in snap["requests"] if e["parked"]] == [victim]
    with pytest.raises(RuntimeError, match="busy"):
        fleet.restore(snap)
    fresh = ServingFleet(net, replicas=1, **KW)
    with pytest.raises(ValueError, match="another|differs"):
        fresh.restore(dict(snap, torch_rng_device="cuda"))
    assert fresh.restore(snap) == len(rids)
    assert _drain(fresh) == ref
    _clean(fresh)


def _session_prompts(rng, n_sessions=3, per=5, sys_pages=2, ps=4, tail=3):
    blocks = [rng.integers(0, 64, (sys_pages * ps,))
              for _ in range(n_sessions)]
    seq = [s for s in range(n_sessions) for _ in range(per)]
    rng.shuffle(seq)
    return [np.concatenate([blocks[s], rng.integers(0, 64, (tail,))])
            .astype(np.int32) for s in seq]


def test_session_routing_beats_round_robin():
    net = _tiny()
    prompts = _session_prompts(np.random.default_rng(19))
    rates = {}
    for router in ("session", "round_robin"):
        fleet = ServingFleet(net, replicas=2, router=router, **KW)
        done, i = 0, 0
        for _ in range(600):
            if i < len(prompts):
                fleet.add_request(prompts[i],
                                  SamplingParams(max_new_tokens=4))
                i += 1
            done += len(fleet.step())
            if done == len(prompts):
                break
        assert done == len(prompts)
        rates[router] = fleet.prefix_hit_rate
        if router == "session":
            assert sum(st["routed_warm"]
                       for st in fleet.replica_stats.values()) > 0
    assert rates["session"] > rates["round_robin"], rates


def test_tenant_fairness_across_replicas():
    net = _tiny()
    rng = np.random.default_rng(20)
    fleet = ServingFleet(net, replicas=2, **dict(KW, max_slots=1))
    for p in _prompts(rng, (5,) * 10):
        fleet.add_request(p, SamplingParams(max_new_tokens=6),
                          tenant="flood")
    sparse = fleet.add_request(_prompts(rng, (6,))[0],
                               SamplingParams(max_new_tokens=6),
                               tenant="sparse")
    done_at = {}
    for step in range(400):
        for o in fleet.step():
            done_at[o.req_id] = step
        if len(done_at) == 11:
            break
    assert done_at[sparse] < max(s for r, s in done_at.items()
                                 if r != sparse)


def test_validates_requests_and_refusals():
    net = _tiny()
    with pytest.raises(ValueError):
        ServingFleet(net, replicas=0, device="cpu")
    with pytest.raises(ValueError, match="router"):
        ServingFleet(net, replicas=1, router="hash", device="cpu")
    fleet = ServingFleet(net, replicas=1, max_slots=1, page_size=8,
                         pool_pages=8, max_context=32, device="cpu")
    with pytest.raises(ValueError):
        fleet.add_request(np.zeros((0,), np.int64))
    with pytest.raises(ValueError):
        fleet.add_request(np.zeros((2, 5), np.int64))
    with pytest.raises(ValueError):
        fleet.add_request(np.arange(30) % 64,
                          SamplingParams(max_new_tokens=64))
    with pytest.raises(ValueError):
        fleet.migrate_request(0, dst=3)
    assert fleet.migrate_request(10**6) is False
    rid = fleet.add_request([1, 2, 3], SamplingParams(max_new_tokens=4))
    assert fleet.cancel(rid).finish_reason == "cancelled"
    assert list(fleet.stream(fleet.add_request(
        [1, 2, 3], SamplingParams(max_new_tokens=3)))).__len__() == 3
    for call in (fleet.steady_state_recompiles,
                 fleet.per_replica_recompiles, fleet.inspect_hotpath):
        with pytest.raises(NotImplementedError, match="item 6"):
            call()
    planned = ServingFleet.from_plan(net, {"replicas": 3}, device="cpu",
                                     max_context=32)
    assert planned.num_replicas == 3
