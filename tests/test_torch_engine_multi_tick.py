"""Multi-tick decode in the port's Engine (``multi_tick=k``) on the CPU,
held to the single-tick port engine and to the JAX Engine with
``multi_tick`` and the same weights (``bridge.py``), prompts from numpy
with a fixed seed. Greedy tokens must match exactly, and the multi-tick
counters (dispatches, ticks, clamps, scan exits) must equal the JAX
engine's on the same trace. On the CPU the k-tick body runs as a Python
loop; its CUDA graph is held on the card (``test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest
import torch

from paddle_tpu import monitor as jmon
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.engine import SamplingParams as JaxParams
from paddle_tpu_torch import monitor
from paddle_tpu_torch.inference import Engine, SamplingParams

from test_torch_engine import _drive, _prompts, _tiny, torch_one_thread
from test_torch_llama import make_pair
from test_torch_moe import make_ernie_pair

MT = ["serving.multi_tick." + n for n in (
    "dispatches", "ticks", "clamp.max_new", "clamp.pages", "clamp.spec",
    "scan_exit.eos", "scan_exit.length", "scan_exit.nan_logits",
    "scan_exit.horizon")]

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _reset(names=MT):
    for n in names:
        jmon.counter(n).reset()
        monitor.counter(n).reset()


def _counts(mon, names=MT):
    return {n: mon.counter(n).get() for n in names}


def _staggered(seed=0):
    rng = np.random.default_rng(seed)
    p = _prompts(rng, (5, 9, 3, 7, 12))
    return {0: [(p[0], 20), (p[1], 13)], 3: [(p[2], 17), (p[3], 9)],
            5: [(p[4], 19)]}


def _jax_vs_port(jnet, tnet, schedule, **kw):
    """(JAX tokens, port tokens, port single-tick tokens, JAX counters,
    port counters, JAX / port free-page trajectories)."""
    _reset()
    jeng = JaxEngine(jnet, multi_tick=8, **kw)
    jdone, jfree = _drive(jeng, JaxParams, schedule)
    tdone, tfree = _drive(Engine(tnet, device="cpu", multi_tick=8, **kw),
                          SamplingParams, schedule)
    jc, tc = _counts(jmon), _counts(monitor)
    sdone, _ = _drive(Engine(tnet, device="cpu", **kw), SamplingParams,
                      schedule)
    jeng.close()
    return jdone, tdone, sdone, jc, tc, jfree, tfree


def test_multi_tick_matches_single_tick_and_jax():
    """k=8 on a staggered trace: the single-tick tokens, the JAX
    engine's tokens, free-page trajectory and multi-tick counters."""
    jnet, tnet, _ = make_pair()
    kw = dict(max_slots=3, page_size=8, pool_pages=64, max_context=64)
    jdone, tdone, sdone, jc, tc, jfree, tfree = _jax_vs_port(
        jnet, tnet, _staggered(), **kw)
    assert tdone == jdone == sdone
    assert tfree == jfree
    assert tc == jc
    assert tc["serving.multi_tick.dispatches"] > 0
    assert tc["serving.multi_tick.ticks"] > \
        2 * tc["serving.multi_tick.dispatches"] - 1


def test_page_coverage_clamp_matches_jax():
    """4-token pages and a pool whose free pages cannot cover 8 ticks
    past the watermark: the fused k is clamped by page coverage (never by
    eviction or preemption), on the same dispatches as the JAX engine."""
    jnet, tnet, _ = make_pair(seed=1)
    rng = np.random.default_rng(1)
    p = _prompts(rng, (6, 10, 3))
    schedule = {0: [(p[0], 18), (p[1], 14), (p[2], 16)]}
    kw = dict(max_slots=3, page_size=4, pool_pages=20, max_context=40,
              prefill_bucket=4, watermark_pages=2)
    _reset(["serving.preemptions"])
    jdone, tdone, sdone, jc, tc, jfree, tfree = _jax_vs_port(
        jnet, tnet, schedule, **kw)
    assert tdone == jdone == sdone
    assert tfree == jfree
    assert tc == jc
    assert tc["serving.multi_tick.clamp.pages"] > 0
    assert monitor.counter("serving.preemptions").get() == \
        jmon.counter("serving.preemptions").get() == 0


def _probe(net, prompt, n):
    return Engine(net, max_slots=2, page_size=4, max_context=48,
                  device="cpu").run(
        [(prompt, SamplingParams(max_new_tokens=n))])[0].token_ids


def test_eos_in_the_middle_of_a_stretch():
    """An eos whose first occurrence lies inside a fused stretch freezes
    that row in the loop: its tokens end at the eos, the other row runs
    on, the tokens equal the single-tick engine's, and the scan exit is
    counted once as eos."""
    net = _tiny(seed=4)
    rng = np.random.default_rng(4)
    a, b = _prompts(rng, (6, 9))
    probe = _probe(net, a, 16)
    # the eos: a token whose FIRST occurrence is inside the first fused
    # stretch (tokens 1.. come from the decode; token 0 from the prefill)
    at = next(i for i in range(3, 8) if probe[i] not in probe[:i])
    eos = probe[at]
    reqs = [(a, SamplingParams(max_new_tokens=16, eos_token_id=eos)),
            (b, SamplingParams(max_new_tokens=16))]
    _reset()
    multi = Engine(net, max_slots=2, page_size=4, max_context=48,
                   device="cpu", multi_tick=8)
    got = multi.run(reqs)
    counts = _counts(monitor)
    single = Engine(net, max_slots=2, page_size=4, max_context=48,
                    device="cpu").run(reqs)
    assert got[0].token_ids == probe[:at + 1]
    assert got[0].finish_reason == "eos"
    assert [o.token_ids for o in got] == [o.token_ids for o in single]
    assert counts["serving.multi_tick.scan_exit.eos"] == 1
    # device ticks, not dispatches: both engines ran 15 ticks
    assert multi.decode_ticks == 15 == \
        counts["serving.multi_tick.ticks"] + (
            multi._steps - counts["serving.multi_tick.dispatches"] - 1)


def test_sampled_request_turns_fusion_off():
    """While a sampled request decodes, every dispatch is a single tick
    (its generator is consumed one draw a tick); once it finishes, the
    greedy rows fuse again. Tokens equal the single-tick engine's."""
    net = _tiny(seed=5)
    rng = np.random.default_rng(5)
    a, b = _prompts(rng, (6, 9))
    reqs = [(a, SamplingParams(max_new_tokens=24)),
            (b, SamplingParams(max_new_tokens=6, temperature=0.9, top_k=8,
                               seed=3))]
    eng = Engine(net, max_slots=2, page_size=4, max_context=48,
                 device="cpu", multi_tick=8)
    for r in reqs:
        eng.add_request(*r)
    _reset()
    done, fused_while_sampled = {}, 0
    while len(done) < 2:
        sampling = any(r is not None and r.params.temperature > 0
                       and r.state == "DECODE" for r in eng._slots)
        before = monitor.counter("serving.multi_tick.dispatches").get()
        for o in eng.step():
            done[o.req_id] = o.token_ids
        if sampling:
            fused_while_sampled += monitor.counter(
                "serving.multi_tick.dispatches").get() - before
    assert fused_while_sampled == 0
    assert monitor.counter("serving.multi_tick.dispatches").get() > 0
    single = Engine(net, max_slots=2, page_size=4, max_context=48,
                    device="cpu").run(reqs)
    assert [done[0], done[1]] == [o.token_ids for o in single]


@pytest.mark.parametrize("k", [8, 6])
def test_multi_bucket_matches_jax(k):
    """The bucket the fused length rounds down to, for every clamped
    length 1..33: powers of two, plus multi_tick itself."""
    jnet, tnet, _ = make_pair()
    jeng = JaxEngine(jnet, multi_tick=k, max_slots=2, max_context=64)
    teng = Engine(tnet, device="cpu", multi_tick=k, max_slots=2,
                  max_context=64)
    assert [teng._multi_bucket(n) for n in range(1, 34)] == \
        [jeng._multi_bucket(n) for n in range(1, 34)]
    jeng.close()


def test_multi_tick_validation_and_spec_exclusion():
    """multi_tick < 1 raises; with a draft model attached every dispatch
    is speculative and counted as the spec exclusion."""
    with pytest.raises(ValueError, match="multi_tick"):
        Engine(_tiny(), device="cpu", multi_tick=0)
    net = _tiny(seed=6)
    _reset()
    eng = Engine(net, device="cpu", max_slots=2, page_size=4,
                 max_context=48, multi_tick=4, draft_model=net, spec_k=2)
    rng = np.random.default_rng(6)
    eng.run([(x, SamplingParams(max_new_tokens=9))
             for x in _prompts(rng, (5, 7))])
    assert monitor.counter("serving.multi_tick.dispatches").get() == 0
    assert monitor.counter("serving.multi_tick.clamp.spec").get() == \
        eng.decode_ticks > 0


def test_ernie_moe_multi_tick_matches_jax():
    """ERNIE-MoE: the fused ticks route their MoE blocks in decode mode
    (frozen rows masked like idle lanes) — the JAX engine's tokens and
    counters, and one kernel-dispatch MoE call a device tick."""
    jnet, tnet, _ = make_ernie_pair(seed=0)
    jnet.eval()
    tnet.eval()
    kw = dict(max_slots=3, page_size=8, pool_pages=64, max_context=64)
    jdone, tdone, sdone, jc, tc, jfree, tfree = _jax_vs_port(
        jnet, tnet, _staggered(2), **kw)
    assert tdone == jdone == sdone
    assert tfree == jfree
    assert tc == jc and tc["serving.multi_tick.dispatches"] > 0


def test_frozen_row_never_writes_a_shared_prefix_page():
    """A row frozen inside a fused stretch (its eos came early) rides at
    cache index -1 with its block table still mapping a prefix-cache
    page; its writes must land in the scratch page, so the shared page's
    K/V stay as written and the request still sharing it emits the
    cache-free engine's tokens."""
    net = _tiny(seed=7)
    rng = np.random.default_rng(7)
    sysp = rng.integers(0, 64, (8,)).astype(np.int32)
    a, b = (np.concatenate([sysp, x]) for x in _prompts(rng, (3, 5)))
    probe = _probe(net, a, 16)
    at = next(i for i in range(2, 7) if probe[i] not in probe[:i])
    reqs = [(a, SamplingParams(max_new_tokens=16, eos_token_id=probe[at])),
            (b, SamplingParams(max_new_tokens=16))]
    kw = dict(max_slots=2, page_size=4, max_context=48, device="cpu")
    eng = Engine(net, prefix_cache=True, multi_tick=8, **kw)
    eng.add_request(*reqs[0])
    eng.step()                                # a prefilled, prefix cached
    eng.add_request(*reqs[1])
    eng.step()                                # b maps a's system pages
    ra, rb = eng._slots[0], eng._slots[1]
    shared = [p for p in rb.pages if p in ra.pages]
    assert shared == ra.pages[:2]
    before = [t[shared].clone() for c in eng._pools for t in c[:2]]
    _reset()
    outs = {}
    while len(outs) < 2:
        outs.update((o.req_id, o.token_ids) for o in eng.step())
    assert monitor.counter("serving.multi_tick.scan_exit.eos").get() == 1
    after = [t[shared] for c in eng._pools for t in c[:2]]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    plain = Engine(net, **kw).run(reqs)
    assert [outs[0], outs[1]] == [o.token_ids for o in plain]


@pytest.mark.parametrize("was_enabled", [True, False])
def test_gc_paused_turns_the_collector_off_and_restores_it(was_enabled):
    """The guard around a graph capture: the cyclic collector is off
    inside (an exception included) and as it was after."""
    import gc
    from paddle_tpu_torch.inference.decode_graph import gc_paused
    (gc.enable if was_enabled else gc.disable)()
    try:
        with gc_paused():
            assert not gc.isenabled()
        assert gc.isenabled() == was_enabled
        with pytest.raises(KeyError):
            with gc_paused():
                raise KeyError("body")
        assert gc.isenabled() == was_enabled
    finally:
        gc.enable()
