"""Chunked prefill in the port's Engine (``max_prefill_tokens_per_step``)
on the CPU, held to the monolithic port engine and to the JAX Engine with
the same weights: the same greedy tokens, prefill slices and free-page
trajectory; a prefix-cache hit deeper than one bucket with its tail still
sliced; preemption of a request at a slice boundary; admission charged
by the per-slice peak.
"""
import numpy as np
import pytest

from paddle_tpu import monitor as jmon
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.engine import SamplingParams as JaxParams
from paddle_tpu_torch import monitor
from paddle_tpu_torch.inference import Engine, SamplingParams

from test_torch_engine import _drive, _prompts, _tiny, torch_one_thread
from test_torch_llama import make_pair

C = ["serving.prefill_slices", "serving.prefill_tokens",
     "serving.preemptions", "serving.prefix_hits",
     "serving.prefix_tokens_reused"]

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _reset():
    for n in C:
        jmon.counter(n).reset()
        monitor.counter(n).reset()


def _counts(mon):
    return {n: mon.counter(n).get() for n in C}


def test_chunked_matches_monolithic_and_jax():
    """Long prompts (33-50 tokens) beside short ones under a 16-token
    step budget: every prompt written in slices, shortest first; the
    JAX engine's tokens, slice count and free-page trajectory, and the
    monolithic engine's tokens."""
    jnet, tnet, _ = make_pair()
    rng = np.random.default_rng(0)
    p = _prompts(rng, (40, 9, 33, 7, 50))
    sched = {0: [(p[0], 8), (p[1], 6)], 2: [(p[2], 8), (p[3], 5)],
             4: [(p[4], 9)]}
    kw = dict(max_slots=3, page_size=8, pool_pages=64, max_context=64,
              prefill_bucket=8)
    _reset()
    jeng = JaxEngine(jnet, max_prefill_tokens_per_step=13, **kw)
    jdone, jfree = _drive(jeng, JaxParams, sched)
    teng = Engine(tnet, device="cpu", max_prefill_tokens_per_step=13, **kw)
    assert teng.max_prefill_tokens_per_step == 16     # rounded to buckets
    tdone, tfree = _drive(teng, SamplingParams, sched)
    assert _counts(monitor) == _counts(jmon)
    assert monitor.counter("serving.prefill_slices").get() > 5
    assert monitor.gauge("serving.prefill_tokens_per_step").get() <= 16
    mono, _ = _drive(Engine(tnet, device="cpu", **kw), SamplingParams, sched)
    assert tdone == jdone == mono
    assert tfree == jfree
    jeng.close()


def test_prefix_hit_deeper_than_one_bucket_is_still_sliced(monkeypatch):
    """A 40-token cached system prompt (five 8-token pages, five buckets)
    is skipped whole; the 30-token uncached tail runs as 16 + 14-token
    slices from start 40; the tokens equal the engine without either."""
    net = _tiny()
    rng = np.random.default_rng(1)
    sysp = rng.integers(0, 64, (40,)).astype(np.int32)
    a, b = (np.concatenate([sysp, x]) for x in _prompts(rng, (2, 30)))
    kw = dict(max_slots=2, page_size=8, max_context=96, prefill_bucket=8)
    eng = Engine(net, device="cpu", prefix_cache=True,
                 max_prefill_tokens_per_step=16, **kw)
    first = eng.run([(a, SamplingParams(max_new_tokens=4))])
    starts = []
    prefill = Engine._prefill

    def spy(self, req, cap=None):
        starts.append(req.written if req.pages else req.prefix_len)
        return prefill(self, req, cap)

    monkeypatch.setattr(Engine, "_prefill", spy)
    _reset()
    second = eng.run([(b, SamplingParams(max_new_tokens=4))])
    assert monitor.counter("serving.prefix_tokens_reused").get() == 40
    assert starts == [40, 56]
    monkeypatch.setattr(Engine, "_prefill", prefill)
    plain = Engine(net, device="cpu", **kw).run(
        [(a, SamplingParams(max_new_tokens=4)),
         (b, SamplingParams(max_new_tokens=4))])
    assert [first[0].token_ids, second[0].token_ids] == \
        [o.token_ids for o in plain]
    assert eng.leaked_pages() == 0


def test_preemption_at_a_slice_boundary_matches_jax(monkeypatch):
    """A whale admitted beside two growing sequences in a pool that
    cannot hold all three: the pool runs dry while the whale is half
    written, and growth preempts it, the youngest, at its slice boundary
    (its pages freed, its prompt restarted on re-admission) — the JAX
    engine's tokens, preemptions, slices and free-page trajectory, and
    nothing leaked."""
    states = []
    preempt = Engine._preempt
    monkeypatch.setattr(Engine, "_preempt", lambda self, r: (
        states.append((r.req_id, r.state, r.written)), preempt(self, r)))
    jnet, tnet, _ = make_pair(seed=2)
    rng = np.random.default_rng(2)
    p = _prompts(rng, (6, 5, 40))
    sched = {0: [(p[0], 20), (p[1], 20)], 1: [(p[2], 6)]}
    kw = dict(max_slots=3, page_size=4, pool_pages=13, max_context=64,
              prefill_bucket=4, watermark_pages=0)
    _reset()
    jeng = JaxEngine(jnet, max_prefill_tokens_per_step=4, **kw)
    jdone, jfree = _drive(jeng, JaxParams, sched)
    teng = Engine(tnet, device="cpu", max_prefill_tokens_per_step=4, **kw)
    tdone, tfree = _drive(teng, SamplingParams, sched)
    assert (2, "PREFILL", 16) in states
    assert _counts(monitor) == _counts(jmon)
    assert tdone == jdone
    assert tfree == jfree
    assert teng.leaked_pages() == 0
    jeng.close()


@pytest.mark.parametrize("chunk", [None, 16])
def test_admission_charges_the_per_slice_peak(chunk):
    """Lifetime page demand as the JAX engine counts it: the bucketed
    whole under monolithic prefill, the real tokens plus the tick's
    lookahead under chunked prefill — so a prompt that fits the pool
    slice by slice is admitted only with chunking, and served."""
    jnet, tnet, _ = make_pair()
    kw = dict(max_slots=2, page_size=8, pool_pages=6, max_context=64,
              prefill_bucket=32, max_prefill_tokens_per_step=chunk)
    jeng = JaxEngine(jnet, **kw)
    teng = Engine(tnet, device="cpu", **kw)
    cases = [(p, n) for p in (1, 17, 33, 40) for n in (1, 7, 8)]
    assert [teng._lifetime_pages(p, n) for p, n in cases] == \
        [jeng._lifetime_pages(p, n) for p, n in cases]
    prompt = np.random.default_rng(3).integers(0, 64, (40,)).astype(
        np.int32)
    if chunk is None:
        with pytest.raises(RuntimeError, match="never be scheduled"):
            teng.add_request(prompt, SamplingParams(max_new_tokens=8))
    else:
        out = teng.run([(prompt, SamplingParams(max_new_tokens=8))])
        assert len(out[0].token_ids) == 8 and teng.leaked_pages() == 0
    jeng.close()
