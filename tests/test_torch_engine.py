"""The slice as a whole: the port's continuous-batching Engine
(paddle_tpu_torch.inference.engine) on the CPU held to the JAX Engine
with the same weights.

The contract: the same greedy tokens, exactly, on a staggered
mixed-length trace and on a trace whose small pool forces preemption
and resume; the same allocator accounting (free pages after every
step, preemption counts, a balanced pool at the end); sampled tokens of
a request independent of its batch-mates; the reliability knobs
(injector, clock, label, deadlines) taken, malformed values refused.
(Sampled tokens are not compared across frameworks: JAX threefry keys
cannot be reproduced in PyTorch.)
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.engine import SamplingParams as JaxParams
from paddle_tpu_torch import monitor
from paddle_tpu_torch.inference import Engine, FaultInjector, SamplingParams
from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

from test_torch_llama import make_pair


def _prompts(rng, lens, vocab=64):
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _drive(eng, params_cls, schedule, max_steps=200):
    """Feed ``schedule`` ({step: [(prompt, max_new), ...]}) into ``eng``
    and step until every request retired. Returns ({req_id: tokens},
    [pages_free after each step])."""
    done, free = {}, []
    total = sum(len(v) for v in schedule.values())
    for step in range(max_steps):
        for prompt, n in schedule.get(step, []):
            eng.add_request(prompt, params_cls(max_new_tokens=n))
        for o in eng.step():
            assert o.error is None, o
            done[o.req_id] = o.token_ids
        free.append(eng.pages_free)
        if len(done) == total and step >= max(schedule):
            break
    assert len(done) == total
    return done, free


def _pair_engines(variant_kw, **eng_kw):
    jnet, tnet, _ = make_pair(**variant_kw)
    return (JaxEngine(jnet, **eng_kw),
            Engine(tnet, device="cpu", **eng_kw))


@pytest.mark.parametrize("variant", [{}, {"kv": 2, "window": 6}],
                         ids=["mha", "gqa_window"])
def test_greedy_tokens_match_jax_staggered(variant):
    rng = np.random.default_rng(0)
    p = _prompts(rng, (5, 9, 3, 7, 12))
    schedule = {0: [(p[0], 8), (p[1], 6)],
                3: [(p[2], 8), (p[3], 5)],
                5: [(p[4], 9)]}
    kw = dict(max_slots=3, page_size=8, pool_pages=64, max_context=64)
    jeng, teng = _pair_engines(variant, **kw)
    jdone, jfree = _drive(jeng, JaxParams, schedule)
    tdone, tfree = _drive(teng, SamplingParams, schedule)
    assert tdone == jdone
    assert tfree == jfree                 # allocator accounting matches
    assert teng.pages_free == teng.pool_pages == jeng.pages_free
    assert teng.num_active == 0 and teng.num_waiting == 0
    jeng.close()


def test_greedy_tokens_match_jax_under_preemption():
    """Both sequences grow to 4 pages but the pool holds 4: growth
    preempts the youngest, which resumes with a re-prefill — the same
    tokens, the same preemptions, the same free-page trajectory."""
    rng = np.random.default_rng(1)
    p = _prompts(rng, (4, 3))
    schedule = {0: [(p[0], 10), (p[1], 10)]}
    kw = dict(max_slots=2, page_size=4, pool_pages=4, max_context=16,
              prefill_bucket=4, watermark_pages=0)
    jeng, teng = _pair_engines({}, **kw)
    from paddle_tpu import monitor as jmon
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


@pytest.fixture(scope="module")
def torch_one_thread():
    """One intra-op thread for a module's tiny engines: the suite's
    parallel workers otherwise oversubscribe the cores and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(seed=0):
    cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4)
    return LlamaForCausalLM(cfg, device="cpu", seed=seed, init_std=0.2)


def test_sampled_tokens_independent_of_batch_mates():
    """A sampled request (its own generator, seeded) emits the same
    tokens served alone and served beside other greedy and sampled
    requests in other slots — and a different seed changes them."""
    net = _tiny()
    rng = np.random.default_rng(2)
    p = _prompts(rng, (6, 4, 9, 5))
    target = SamplingParams(max_new_tokens=12, temperature=1.0, top_k=20,
                            top_p=0.9, seed=5)
    alone = Engine(net, max_slots=4, page_size=4, max_context=48,
                   device="cpu").run([(p[0], target)])[0].token_ids
    mates = [(p[1], SamplingParams(max_new_tokens=7)),
             (p[2], SamplingParams(max_new_tokens=9, temperature=0.8,
                                   seed=1)),
             (p[3], SamplingParams(max_new_tokens=5, temperature=1.3,
                                   top_k=4, seed=2))]
    outs = Engine(net, max_slots=4, page_size=4, max_context=48,
                  device="cpu").run(mates + [(p[0], target)])
    assert outs[-1].token_ids == alone
    other = SamplingParams(max_new_tokens=12, temperature=1.0, top_k=20,
                           top_p=0.9, seed=6)
    again = Engine(net, max_slots=4, page_size=4, max_context=48,
                   device="cpu").run([(p[0], other)])[0].token_ids
    assert again != alone


def test_greedy_rows_match_the_no_cache_model():
    """Teacher-forced argmax of the no-cache forward over prompt +
    emitted tokens reproduces every greedy token the engine emitted (the
    paged prefill/decode path and the flash path agree)."""
    net = _tiny(seed=3)
    rng = np.random.default_rng(3)
    p = _prompts(rng, (7, 10))
    outs = Engine(net, max_slots=2, page_size=4, max_context=32,
                  device="cpu").run(
        [(x, SamplingParams(max_new_tokens=8)) for x in p])
    for x, o in zip(p, outs):
        seq = np.concatenate([x, np.asarray(o.token_ids[:-1], np.int32)])
        with torch.no_grad():
            logits = net(torch.from_numpy(seq[None]))[0]
        want = logits[len(x) - 1:].argmax(-1).tolist()
        assert o.token_ids == want


@pytest.mark.parametrize("knob", [
    dict(fault_injector=FaultInjector(seed=1)), dict(clock=lambda: 0.0),
    dict(label="replica0")], ids=lambda k: next(iter(k)))
def test_unsupported_knobs_raise(knob):
    """The reliability knobs an earlier slice refused are served now:
    the engine takes each, it is in effect on a run (the injector is the
    engine's, a constant clock stamps every span and latency at 0, the
    label names every span's origin), and a malformed value raises."""
    eng = Engine(_tiny(), device="cpu", **knob)
    out = eng.run([([1, 2, 3], SamplingParams(max_new_tokens=3))])[0]
    assert out.ok and out.spans[-1]["phase"] == "FINISHED"
    if "fault_injector" in knob:
        assert eng._injector is knob["fault_injector"]
        with pytest.raises(ValueError, match="unknown fault site"):
            FaultInjector(sites=("bogus.site",))
    if "clock" in knob:
        assert out.ttft_ms == 0.0
        assert {s["t0_ms"] for s in out.spans} == {0.0}
    if "label" in knob:
        assert {s["origin"] for s in out.spans} == {"replica0"}
        with pytest.raises(ValueError, match="multi_tick"):
            Engine(_tiny(), device="cpu", multi_tick=0, **knob)


def test_unsupported_request_knobs_raise():
    """deadline_ms and max_queue_steps are accepted; non-positive values
    and a request beyond max_context raise ValueError."""
    eng = Engine(_tiny(), device="cpu")
    eng.add_request([1, 2, 3], SamplingParams(deadline_ms=5.0,
                                              max_queue_steps=2))
    with pytest.raises(ValueError, match="deadline_ms"):
        eng.add_request([1, 2, 3], SamplingParams(deadline_ms=-1.0))
    with pytest.raises(ValueError, match="max_queue_steps"):
        eng.add_request([1, 2, 3], SamplingParams(max_queue_steps=0))
    with pytest.raises(ValueError, match="max_context"):
        eng.add_request(list(range(250)), SamplingParams(max_new_tokens=16))
    assert eng.num_waiting == 1

