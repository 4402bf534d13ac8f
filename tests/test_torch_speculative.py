"""Speculative decoding in the port (``text.generation.verify_token_arrays``,
``inference/speculative.py`` and the Engine's draft/verify tick) on the
CPU: the verify walk against the JAX one (greedy) and against the
port's own sampler (sampled); the draft engine against the plain port
engine for greedy and seeded sampled requests (a sampled row's generator
ends accepted + 1 draws on, as plain decoding leaves it); greedy tokens
and the spec counters against the JAX spec engine with the same weights;
a self-draft accepting everything; GQA with an int8 pool and a window;
preemption; an eos in the middle of an accepted chain; draft validation;
a dense draft over ERNIE-MoE.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import monitor as jmon
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.engine import SamplingParams as JaxParams
from paddle_tpu.text.generation import verify_token_arrays as jax_verify
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import monitor
from paddle_tpu_torch.bridge import llama_state_from_numpy
from paddle_tpu_torch.inference import Engine, SamplingParams
from paddle_tpu_torch.text.generation import (gumbel_noise,
                                              sample_token_arrays,
                                              verify_token_arrays)
from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

from test_torch_engine import _drive, _prompts, torch_one_thread
from test_torch_llama import make_pair
from test_torch_moe import make_ernie_pair

SPEC = ["serving.spec_drafted", "serving.spec_accepted",
        "serving.preemptions"]

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _reset():
    for n in SPEC:
        jmon.counter(n).reset()
        monitor.counter(n).reset()


def _counts(mon):
    return {n: mon.counter(n).get() for n in SPEC}


def _draft_of(jnet, params):
    """(jax, torch) 1-layer drafts holding the target's embedding, first
    layer, final norm and head: they agree with it often, not always."""
    keep = {k: v for k, v in params.items()
            if not k.startswith("llama.layers.")
            or k.startswith("llama.layers.0.")}
    jc = dataclasses.replace(jnet.config, num_hidden_layers=1)
    jd = JaxLlama(jc)
    jd.set_state_dict(keep)
    jd.eval()
    td = LlamaForCausalLM(LlamaConfig(**dataclasses.asdict(jc)),
                          device="cpu")
    td.load_state_dict(llama_state_from_numpy(keep))
    td.eval()
    return jd, td


def _trace(seed, lens=(5, 9, 3, 7, 12), new=(14, 10, 12, 9, 11)):
    p = _prompts(np.random.default_rng(seed), lens)
    return {0: [(p[0], new[0]), (p[1], new[1])],
            3: [(p[2], new[2]), (p[3], new[3])], 5: [(p[4], new[4])]}


def test_verify_token_arrays_greedy_matches_jax():
    """Greedy verify of k+1 = 5 scored positions against drafts that
    match the argmax for a random prefix of each row: the same tokens
    and accept counts as the JAX walk."""
    rng = np.random.default_rng(0)
    b, n, V = 6, 5, 32
    logits = rng.standard_normal((b, n, V)).astype(np.float32)
    drafts = logits[:, :-1].argmax(-1).astype(np.int32)
    for r, cut in enumerate((0, 1, 2, 3, 4, 2)):
        if cut < n - 1:
            drafts[r, cut] = (drafts[r, cut] + 1) % V
    want_t, want_a, _ = jax_verify(
        jnp.asarray(logits), jnp.asarray(drafts),
        jnp.zeros((b, 2), jnp.uint32), jnp.zeros((b,)), jnp.zeros((b,)),
        jnp.zeros((b,)), greedy=True)
    got_t, got_a = verify_token_arrays(
        torch.from_numpy(logits), torch.from_numpy(drafts), None,
        torch.zeros(b), torch.zeros(b, dtype=torch.long), torch.zeros(b),
        greedy=True)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    assert got_a.tolist() == [0, 1, 2, 3, 4, 2]


@pytest.mark.parametrize("use_filters", [False, True])
def test_verify_sampled_walks_the_sampler(use_filters):
    """Sampled verify: position j's token is ``sample_token_arrays`` of
    that position's logits with that position's noise; a draft equal to
    it is accepted, the first one that differs ends the chain."""
    g = torch.Generator().manual_seed(1)
    b, n, V = 4, 4, 16
    logits = torch.randn(b, n, V, generator=g)
    noise = torch.stack([torch.stack([gumbel_noise(V, g, "cpu")
                                      for _ in range(n)]) for _ in range(b)])
    temps = torch.tensor([0.0, 0.7, 1.0, 1.3])
    topk = torch.tensor([0, 5, 0, 3])
    topp = torch.tensor([0.0, 0.0, 0.9, 0.8])
    want = torch.stack([sample_token_arrays(
        logits[:, j], noise[:, j], temps, topk, topp,
        use_filters=use_filters) for j in range(n)], dim=1)
    drafts = want[:, :-1].clone()
    drafts[1, 1] = (drafts[1, 1] + 1) % V
    drafts[3, 0] = (drafts[3, 0] + 1) % V
    toks, acc = verify_token_arrays(logits, drafts, noise, temps, topk,
                                    topp, use_filters=use_filters)
    assert torch.equal(toks, want)
    assert acc.tolist() == [3, 1, 3, 0]


def test_spec_engine_matches_plain_engine_greedy_and_sampled():
    """Greedy, plain-sampled and filtered-sampled requests (seeded)
    through the draft/verify engine: every request's tokens equal the
    plain engine's — the sampled rows' generators advance exactly
    accepted + 1 draws a tick."""
    jnet, tnet, params = make_pair()
    _, tdraft = _draft_of(jnet, params)
    rng = np.random.default_rng(1)
    p = _prompts(rng, (5, 9, 3, 7))
    reqs = [(p[0], SamplingParams(max_new_tokens=14)),
            (p[1], SamplingParams(max_new_tokens=12, temperature=0.8,
                                  seed=3)),
            (p[2], SamplingParams(max_new_tokens=13, temperature=1.1,
                                  top_k=9, top_p=0.9, seed=4)),
            (p[3], SamplingParams(max_new_tokens=11))]
    kw = dict(max_slots=4, page_size=8, max_context=64)
    _reset()
    spec = Engine(tnet, device="cpu", draft_model=tdraft, spec_k=3,
                  **kw).run(reqs)
    assert 0 < monitor.counter("serving.spec_accepted").get() < \
        monitor.counter("serving.spec_drafted").get()
    plain = Engine(tnet, device="cpu", **kw).run(reqs)
    assert [o.token_ids for o in spec] == [o.token_ids for o in plain]


def test_spec_greedy_matches_jax():
    """The JAX spec engine's greedy tokens, drafted / accepted counts
    and free-page trajectory, with the same target and draft weights."""
    jnet, tnet, params = make_pair()
    jdraft, tdraft = _draft_of(jnet, params)
    sched = _trace(2)
    kw = dict(max_slots=3, page_size=8, pool_pages=64, max_context=64)
    _reset()
    jeng = JaxEngine(jnet, draft_model=jdraft, spec_k=3, **kw)
    jdone, jfree = _drive(jeng, JaxParams, sched)
    teng = Engine(tnet, device="cpu", draft_model=tdraft, spec_k=3, **kw)
    tdone, tfree = _drive(teng, SamplingParams, sched)
    assert _counts(monitor) == _counts(jmon)
    assert teng.spec_accept_rate == pytest.approx(jeng.spec_accept_rate)
    assert 0.0 < teng.spec_accept_rate < 1.0
    assert tdone == jdone
    assert tfree == jfree
    assert teng.leaked_pages() == 0
    jeng.close()


def test_self_draft_accepts_everything():
    """The target as its own draft: every drafted token is accepted (a
    tick emits k+1 tokens) and the tokens are the plain engine's."""
    _, tnet, _ = make_pair(seed=1)
    sched = _trace(3)
    kw = dict(max_slots=3, page_size=8, max_context=64)
    eng = Engine(tnet, device="cpu", draft_model=tnet, spec_k=4, **kw)
    done, _ = _drive(eng, SamplingParams, sched)
    plain, _ = _drive(Engine(tnet, device="cpu", **kw), SamplingParams,
                      sched)
    assert done == plain
    assert eng.spec_accept_rate == 1.0


def test_gqa_int8_pool_window():
    """GQA (2 kv heads), a 6-token window and an int8 pool: the verify
    forward reads the quantized pages through the gather path, the
    decode through the decode path — the same tokens as the plain
    engine, draft and target pools both int8."""
    jnet, tnet, params = make_pair(kv=2, window=6)
    _, tdraft = _draft_of(jnet, params)
    sched = _trace(4)
    kw = dict(max_slots=3, page_size=4, max_context=64,
              cache_dtype="int8")
    eng = Engine(tnet, device="cpu", draft_model=tdraft, spec_k=3, **kw)
    assert eng._spec._pools[0][0].dtype == torch.int8
    assert len(eng._spec._pools[0]) == 4
    done, _ = _drive(eng, SamplingParams, sched)
    plain, _ = _drive(Engine(tnet, device="cpu", **kw), SamplingParams,
                      sched)
    assert done == plain


def test_spec_through_preemption():
    """A pool too small for two growing sequences: growth (k+1 positions
    of lookahead) preempts the youngest, a sampled request, which resumes
    through a re-prefill of both pools — the plain engine's tokens."""
    jnet, tnet, params = make_pair(seed=2)
    _, tdraft = _draft_of(jnet, params)
    rng = np.random.default_rng(5)
    p = _prompts(rng, (4, 3))
    reqs = [(p[0], SamplingParams(max_new_tokens=16)),
            (p[1], SamplingParams(max_new_tokens=16, temperature=0.9,
                                  seed=7))]
    kw = dict(max_slots=2, page_size=4, pool_pages=7, max_context=24,
              prefill_bucket=4, watermark_pages=0)
    _reset()
    eng = Engine(tnet, device="cpu", draft_model=tdraft, spec_k=2, **kw)
    spec = eng.run(reqs)
    assert monitor.counter("serving.preemptions").get() > 0
    assert sum(o.preemptions for o in spec) > 0
    plain = Engine(tnet, device="cpu", **kw).run(reqs)
    assert [o.token_ids for o in spec] == [o.token_ids for o in plain]
    assert eng.leaked_pages() == 0


def test_eos_in_the_middle_of_an_accepted_chain():
    """A self-draft accepts whole chains; an eos whose first occurrence
    falls inside one ends the request there, the rest of the chain
    dropped — the plain engine's tokens."""
    _, tnet, _ = make_pair(seed=4)
    prompt = np.random.default_rng(6).integers(0, 64, (6,)).astype(
        np.int32)
    kw = dict(max_slots=2, page_size=8, max_context=64)
    probe = Engine(tnet, device="cpu", **kw).run(
        [(prompt, SamplingParams(max_new_tokens=16))])[0].token_ids
    # with k = 4 a tick emits tokens 1-5, 6-10, ...: pick one mid-chain
    at = next(i for i in (3, 2, 7, 8, 12) if probe[i] not in probe[:i])
    params = SamplingParams(max_new_tokens=16, eos_token_id=probe[at])
    out = Engine(tnet, device="cpu", draft_model=tnet, spec_k=4,
                 **kw).run([(prompt, params)])[0]
    assert out.token_ids == probe[:at + 1]
    assert out.finish_reason == "eos"


def test_draft_validation():
    _, tnet, _ = make_pair()
    kw = dict(device="cpu", max_context=64)
    wrong_vocab = LlamaForCausalLM(LlamaConfig.tiny(vocab=32, hidden=64,
                                                    layers=1),
                                   device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        Engine(tnet, draft_model=wrong_vocab, **kw)
    short = LlamaForCausalLM(dataclasses.replace(
        tnet.config, num_hidden_layers=1, max_position_embeddings=32),
        device="cpu")
    with pytest.raises(ValueError, match="max_context"):
        Engine(tnet, draft_model=short, **kw)
    with pytest.raises(ValueError, match="spec_k"):
        Engine(tnet, draft_model=tnet, spec_k=0, **kw)

    class NoCache(torch.nn.Module):
        def forward(self, ids):
            return ids

    with pytest.raises(ValueError, match="kv_caches"):
        Engine(tnet, draft_model=NoCache(), **kw)


def test_dense_draft_over_ernie_moe_matches_jax():
    """A 1-layer dense LLaMA drafting for an ERNIE-MoE verifier (the
    verify forward routes k+1 positions a slot in decode mode): the JAX
    spec engine's greedy tokens and spec counters."""
    jmoe, tmoe, _ = make_ernie_pair(seed=0)
    jmoe.eval()
    tmoe.eval()
    jdraft, tdraft, _ = make_pair(seed=7, layers=1)
    sched = _trace(7)
    kw = dict(max_slots=3, page_size=8, pool_pages=64, max_context=64)
    _reset()
    jeng = JaxEngine(jmoe, draft_model=jdraft, spec_k=3, **kw)
    jdone, jfree = _drive(jeng, JaxParams, sched)
    teng = Engine(tmoe, device="cpu", draft_model=tdraft, spec_k=3, **kw)
    tdone, tfree = _drive(teng, SamplingParams, sched)
    assert _counts(monitor) == _counts(jmon)
    assert tdone == jdone
    assert tfree == jfree
    assert set(teng.moe_decode_path()) == {"pallas"}
    jeng.close()
