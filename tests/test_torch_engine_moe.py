"""ERNIE-MoE through the port's continuous-batching Engine on the CPU,
held to the JAX Engine with the same weights (the patterns of
``tests/test_serving_moe.py``): the same greedy tokens, exactly, on a
staggered trace and under preemption; the same allocator trajectory; a
dead lane claims no expert slot; every MoE call of a prefill chunk or a
decode tick is reported by ``moe_decode_path()`` as the kernel dispatch.
(The JAX engine's decode path on the CPU is its scatter fallback, with
the same routing.)
"""
import numpy as np
import pytest
import torch

from paddle_tpu import monitor as jmon
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.engine import SamplingParams as JaxParams
from paddle_tpu_torch import monitor
from paddle_tpu_torch.inference import Engine, SamplingParams
from paddle_tpu_torch.kernels import moe as moe_kernels

from test_torch_engine import _drive, _prompts
from test_torch_moe import make_ernie_pair


def _pair(seed, **eng_kw):
    jnet, tnet, _ = make_ernie_pair(seed=seed)
    jnet.eval()
    tnet.eval()
    return JaxEngine(jnet, **eng_kw), Engine(tnet, device="cpu", **eng_kw)


def test_greedy_tokens_match_jax_staggered():
    rng = np.random.default_rng(0)
    p = _prompts(rng, (5, 9, 3, 7, 12))
    schedule = {0: [(p[0], 8), (p[1], 6)],
                3: [(p[2], 8), (p[3], 5)],
                5: [(p[4], 9)]}
    kw = dict(max_slots=3, page_size=8, pool_pages=64, max_context=64)
    jeng, teng = _pair(0, **kw)
    jdone, jfree = _drive(jeng, JaxParams, schedule)
    tdone, tfree = _drive(teng, SamplingParams, schedule)
    assert tdone == jdone
    assert tfree == jfree
    assert teng.pages_free == teng.pool_pages
    assert teng.moe_pallas_eligible and teng.moe_fallback_reason is None
    paths = teng.moe_decode_path()
    # one MoE block: one kernel-dispatch call per prefill chunk and tick
    assert set(paths) == {"pallas"}
    assert paths["pallas"] == teng.decode_ticks + 5
    jeng.close()


def test_greedy_tokens_match_jax_under_preemption():
    """The pool holds 4 pages and both sequences grow to 4: growth
    preempts the youngest, which resumes with a re-prefill that reroutes
    identically — the same tokens and preemptions as the JAX engine."""
    rng = np.random.default_rng(1)
    p = _prompts(rng, (4, 3))
    schedule = {0: [(p[0], 10), (p[1], 10)]}
    kw = dict(max_slots=2, page_size=4, pool_pages=4, max_context=16,
              prefill_bucket=4, watermark_pages=0)
    jeng, teng = _pair(2, **kw)
    jmon.counter("serving.preemptions").reset()
    monitor.counter("serving.preemptions").reset()
    jdone, jfree = _drive(jeng, JaxParams, schedule)
    tdone, tfree = _drive(teng, SamplingParams, schedule)
    assert monitor.counter("serving.preemptions").get() > 0
    assert (monitor.counter("serving.preemptions").get()
            == jmon.counter("serving.preemptions").get())
    assert tdone == jdone
    assert tfree == jfree
    assert teng.leaked_pages() == 0
    jeng.close()


def test_dead_lanes_claim_no_expert_slot(monkeypatch):
    """In a decode tick with idle lanes, the grouped FFN sees exactly
    top_k live rows per live lane (counts sum), and a request's tokens do
    not depend on its batch-mates (alone vs beside two others)."""
    _, tnet, _ = make_ernie_pair(seed=3)
    tnet.eval()
    seen = []
    real = moe_kernels.grouped_ffn_fwd

    def spy(x, w1, b1, w2, b2, ws, counts, activation="gelu"):
        seen.append((x.shape[1], int(counts.sum())))
        return real(x, w1, b1, w2, b2, ws, counts, activation)

    monkeypatch.setattr(moe_kernels, "grouped_ffn_fwd", spy)
    rng = np.random.default_rng(3)
    p = _prompts(rng, (6, 4, 9))
    eng = Engine(tnet, max_slots=4, page_size=4, max_context=48,
                 device="cpu")
    outs = eng.run([(x, SamplingParams(max_new_tokens=n))
                    for x, n in zip(p, (5, 7, 3))])
    ticks = [(cap, live) for cap, live in seen if cap == 8]  # 4 lanes x k 2
    assert ticks and all(live % 2 == 0 and live <= 6 for _, live in ticks)
    assert any(live < 6 for _, live in ticks)       # idle lanes skipped
    alone = Engine(tnet, max_slots=4, page_size=4, max_context=48,
                   device="cpu").run([(p[1], SamplingParams(
                       max_new_tokens=7))])[0]
    assert alone.token_ids == outs[1].token_ids


def test_moe_engine_counters_and_fallback_reason():
    """A layer that leaves the kernel path is named once at construction
    (``serving.moe.decode_fallback``) and its ticks are counted as the
    fallback."""
    _, tnet, _ = make_ernie_pair(seed=4)
    tnet.eval()
    for lyr in tnet.moe_layers():
        lyr.experts._act = "silu"
    before = monitor.counter("serving.moe.decode_fallback").get()
    eng = Engine(tnet, max_slots=2, page_size=4, max_context=32,
                 device="cpu")
    assert monitor.counter("serving.moe.decode_fallback").get() == before + 1
    assert eng.moe_fallback_reason == "activation"
    assert not eng.moe_pallas_eligible
    eng.run([(np.arange(5), SamplingParams(max_new_tokens=3))])
    assert set(eng.moe_decode_path()) == {"fallback.activation"}
    assert monitor.counter("serving.moe.decode_path.fallback.activation") \
        .get() >= sum(eng.moe_decode_path().values())


@pytest.mark.parametrize("n_slots", [1, 3])
def test_greedy_rows_match_the_no_cache_model(n_slots):
    """Teacher-forced argmax of the no-cache forward reproduces the
    engine's greedy tokens (the paged prefill/decode path with decode-mode
    MoE and the no-cache path with training-mode routing agree while no
    token is dropped)."""
    _, tnet, _ = make_ernie_pair(seed=5)
    tnet.eval()
    rng = np.random.default_rng(5)
    p = _prompts(rng, (7, 10, 5))[:n_slots]
    outs = Engine(tnet, max_slots=n_slots, page_size=4, max_context=32,
                  device="cpu").run(
        [(x, SamplingParams(max_new_tokens=6)) for x in p])
    for x, o in zip(p, outs):
        seq = np.concatenate([x, np.asarray(o.token_ids[:-1], np.int32)])
        with torch.no_grad():
            logits = tnet(torch.from_numpy(seq[None]))[0]
        assert o.token_ids == logits[len(x) - 1:].argmax(-1).tolist()
