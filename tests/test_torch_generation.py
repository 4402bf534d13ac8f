"""One-shot decoding of the port (``paddle_tpu_torch.text.generate`` /
``beam_search``) held to the JAX package on the CPU with the same weights:

- ``generate`` token for token with f32 caches on every path (dense,
  rolling, paged, "auto", the padded ``use_cache=False`` fallback), with
  per-row budgets and eos, on a GQA windowed LLaMA, an MHA LLaMA and a
  tiny ERNIE-MoE;
- the port's own layout matrices at bf16 and int8 (dense == rolling ==
  paged, token-exact), and the int8 >= 0.99 quality gate of
  ``tests/test_decode_cache.py``;
- sampling, which cannot repeat JAX's threefry draws, by its properties:
  one seed one sequence, ``top_k=1`` greedy, every token inside the
  teacher-forced top-k / top-p keep set, and the picker's frequencies
  against ``softmax(logits / T)``;
- ``beam_search`` token for token (eos, ``length_penalty=0.8``, 3 and 4
  beams), its ``num_beams=1`` hand-over, and a constructed tie broken by
  the lowest index as ``jax.lax.top_k`` breaks it;
- the argument checks.
"""
import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
from paddle_tpu.text.generation import beam_search as jax_beam
from paddle_tpu.text.generation import generate as jax_generate
from paddle_tpu_torch import monitor
from paddle_tpu_torch.text import beam_search, generate
from paddle_tpu_torch.text.generation import (CACHE_BUCKET, _beam_search,
                                              _top_k_first, gumbel_noise,
                                              sample_token_arrays)

from test_torch_engine import torch_one_thread
from test_torch_llama import make_pair
from test_torch_moe import make_ernie_pair

pytestmark = pytest.mark.usefixtures("torch_one_thread")

NEW = 12


def _prompts(seed, b=3, s=9, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int64)


def _jax(fn, net, ids, *args, **kw):
    return np.asarray(fn(net, paddle.to_tensor(ids), *args, **kw).numpy())


@pytest.fixture(scope="module")
def window_pair():
    """GQA 4 -> 2 heads, window 6: the layouts of tests/test_decode_cache."""
    jnet, tnet, _ = make_pair(kv=2, window=6)
    return jnet, tnet


@pytest.fixture(scope="module")
def mha_pair():
    jnet, tnet, _ = make_pair(seed=1)
    return jnet, tnet


@pytest.mark.parametrize("impl", ["dense", "rolling", "paged", "auto",
                                  "padded"])
def test_generate_matches_jax_f32(window_pair, impl):
    jnet, tnet = window_pair
    ids = _prompts(0)
    kw = dict(use_cache=False) if impl == "padded" else dict(
        cache_impl=impl, page_size=4, cache_dtype="float32")
    want = _jax(jax_generate, jnet, ids, NEW, **kw)
    counters = ("kernels.decode.dense", "kernels.decode.rolling",
                "kernels.decode.paged_plain", "kernels.flash.fwd_plain")
    before = {c: monitor.counter(c).get() for c in counters}
    got = generate(tnet, ids, NEW, **kw)
    runs = {c: monitor.counter(c).get() - before[c] for c in counters}
    assert got.dtype == torch.int64 and tuple(got.shape) == (3, 9 + NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    layers = tnet.config.num_hidden_layers
    # one forward a step; the prefill plus NEW - 1 steps on a cache
    if impl == "padded":
        assert runs["kernels.flash.fwd_plain"] == NEW * layers
    elif impl == "paged":
        assert runs["kernels.decode.paged_plain"] == (NEW - 1) * layers
    else:   # 9 + bucketed(12) = 73 > window 6: "auto" picks rolling
        name = "dense" if impl == "dense" else "rolling"
        assert runs[f"kernels.decode.{name}"] == NEW * layers


@pytest.mark.parametrize("impl", ["dense", "paged", "padded"])
def test_generate_per_row_budgets_and_eos_match_jax(mha_pair, impl):
    """Per-row budgets [3, 12, 7] and per-row eos, and one scalar eos: the
    eos ids are tokens the greedy run emits, so rows freeze mid-run."""
    jnet, tnet = mha_pair
    ids = _prompts(1)
    kw = dict(use_cache=False) if impl == "padded" else dict(
        cache_impl=impl, page_size=4, cache_dtype="float32")
    free = generate(tnet, ids, NEW, **kw).numpy()
    eos_rows = np.array([free[0, 10], free[1, 13], free[2, 11]])
    for mx, eos in ((np.array([3, 12, 7]), eos_rows),
                    (NEW, int(free[1, 12])), (np.array([5, 0, 9]), None)):
        want = _jax(jax_generate, jnet, ids, mx, eos_token_id=eos, **kw)
        got = generate(tnet, ids, mx, eos_token_id=eos, **kw).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["dense", "paged"])
def test_ernie_moe_generate_matches_jax(impl):
    jnet, tnet, _ = make_ernie_pair(seed=2)
    jnet.eval()
    tnet.eval()
    ids = _prompts(2, b=2, s=7)
    kw = dict(cache_impl=impl, page_size=4, cache_dtype="float32")
    want = _jax(jax_generate, jnet, ids, 10, **kw)
    before = monitor.counter("kernels.moe.decode_path.pallas").get()
    got = generate(tnet, ids, 10, **kw).numpy()
    # every MoE block of the prefill and of the 9 steps in decode mode
    assert monitor.counter("kernels.moe.decode_path.pallas").get() \
        - before == 10
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_layout_matrix_token_exact(window_pair, dtype):
    """Within the port, dense, rolling and paged caches share the write's
    rounding (bf16) or quantize -> dequantize round trip (int8) and read
    the cache in f32: identical greedy tokens."""
    _, tnet = window_pair
    ids = _prompts(3)
    outs = {impl: generate(tnet, ids, NEW, cache_impl=impl, page_size=4,
                           cache_dtype=dtype).numpy()
            for impl in ("dense", "rolling", "paged")}
    np.testing.assert_array_equal(outs["rolling"], outs["dense"])
    np.testing.assert_array_equal(outs["paged"], outs["dense"])


def test_int8_kv_quality_gate():
    """int8 caches track f32 caches at >= 99 % greedy agreement, on the
    net and the prompts of tests/test_decode_cache.py's gate (paddle seed
    0, the ``rng`` fixture's generator)."""
    _, tnet, _ = make_pair(seed=0)
    rng = np.random.default_rng(0)
    total = agree = 0
    for b, s, new in [(4, 9, 32), (2, 5, 16)]:
        ids = rng.integers(0, 64, (b, s)).astype(np.int64)
        ref = generate(tnet, ids, new, cache_dtype="float32").numpy()
        got = generate(tnet, ids, new, cache_dtype="int8").numpy()
        total += b * new
        agree += int(np.sum(got[:, s:] == ref[:, s:]))
    assert agree / total >= 0.99, (agree, total)


def _keep_sets(logits, temperature, top_k, top_p):
    """pick_next's keep set of each row: top-k (ranks < k) then the
    nucleus of the renormalised survivors."""
    scaled = logits / temperature
    order = np.argsort(-scaled, kind="stable")
    svals = np.take_along_axis(scaled, order, -1)
    keep = np.arange(scaled.shape[-1])[None].repeat(len(scaled), 0) < top_k
    p = np.exp(svals - svals.max(-1, keepdims=True)) * keep
    p /= p.sum(-1, keepdims=True)
    keep &= (np.cumsum(p, -1) - p) < top_p
    out = np.zeros_like(keep)
    np.put_along_axis(out, order, keep, -1)
    return out


def test_sampling_properties(mha_pair):
    _, tnet = mha_pair
    ids = _prompts(5)
    kw = dict(temperature=0.9, top_k=5, top_p=0.8)
    a = generate(tnet, ids, NEW, seed=3, **kw)
    b = generate(tnet, ids, NEW, seed=3, **kw)
    c = generate(tnet, ids, NEW, seed=4, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    greedy = generate(tnet, ids, NEW)
    assert torch.equal(generate(tnet, ids, NEW, temperature=1.3, top_k=1,
                                seed=7), greedy)
    # every sampled token lies in the keep set of its teacher-forced logits
    with torch.no_grad():
        logits = tnet(a[:, :-1]).float().numpy()
    s = ids.shape[1]
    for j in range(s, s + NEW):
        keep = _keep_sets(logits[:, j - 1], 0.9, 5, 0.8)
        assert keep[np.arange(3), a[:, j].numpy()].all(), j


def test_sampler_frequencies_follow_softmax():
    """The Gumbel-max picker draws token i with probability
    softmax(logits / T)_i: 40000 draws within 0.01 of it."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, 1.5, 0.2, -0.3]])
    T, n = 0.7, 40000
    gen = torch.Generator().manual_seed(0)
    noise = gumbel_noise((n, 8), gen, "cpu")
    tok = sample_token_arrays(logits.expand(n, 8), noise,
                              torch.full((n,), T), torch.zeros(n),
                              torch.zeros(n), use_filters=False)
    freq = torch.bincount(tok, minlength=8).double() / n
    want = torch.softmax(logits[0].double() / T, -1)
    assert float((freq - want).abs().max()) < 0.01


@pytest.mark.parametrize("k,eos,lp", [(3, 7, 0.8), (4, None, 1.0),
                                      (4, 11, 0.8)])
def test_beam_search_matches_jax(window_pair, k, eos, lp):
    jnet, tnet = window_pair
    ids = _prompts(6, b=2, s=7)
    want = _jax(jax_beam, jnet, ids, 10, num_beams=k, length_penalty=lp,
                eos_token_id=eos, cache_dtype="float32")
    got = beam_search(tnet, ids, 10, num_beams=k, length_penalty=lp,
                      eos_token_id=eos, cache_dtype="float32").numpy()
    np.testing.assert_array_equal(got, want)


def test_beam_search_scores_and_one_beam(mha_pair):
    """The best beam's length-normalised score equals the teacher-forced
    log-probability of its tokens; num_beams=1 is greedy generate."""
    _, tnet = mha_pair
    ids = _prompts(7, b=2, s=6)
    eos = int(generate(tnet, ids, 8).numpy()[0, 9])
    tokens, norm, lens = _beam_search(tnet, ids, 8, 3, 0.8, eos, "float32")
    with torch.no_grad():
        lp = torch.log_softmax(tnet(tokens).float(), -1)
    for r in range(2):
        n = int(lens[r])
        picked = lp[r, 5:5 + n].gather(-1, tokens[r, 6:6 + n, None].long())
        want = float(picked.sum()) / n ** 0.8
        assert abs(float(norm[r]) - want) <= 1e-5 * abs(want)
    np.testing.assert_array_equal(
        beam_search(tnet, ids, 8, num_beams=1, eos_token_id=eos).numpy(),
        generate(tnet, ids, 8, eos_token_id=eos).numpy())


def test_beam_search_ties_take_the_lowest_index(mha_pair):
    """A zeroed head makes every candidate tie: the beams are the lowest
    (beam, token) indices, as jax.lax.top_k orders them."""
    jnet, tnet = mha_pair
    ids = _prompts(8, b=2, s=5)
    w = tnet.lm_head.weight.detach().clone()
    jw = jnet.lm_head.weight
    jsaved = np.asarray(jw.numpy())
    try:
        with torch.no_grad():
            tnet.lm_head.weight.zero_()
        jw.set_value(np.zeros_like(jsaved))
        want = _jax(jax_beam, jnet, ids, 4, num_beams=3,
                    cache_dtype="float32")
        got = beam_search(tnet, ids, 4, num_beams=3,
                          cache_dtype="float32").numpy()
    finally:
        with torch.no_grad():
            tnet.lm_head.weight.copy_(w)
        jw.set_value(jsaved)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 5:] == 0).all()
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 3.0]])
    vals, idx = _top_k_first(x, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]


class _NoCacheLM(nn.Module):
    """A causal LM whose forward takes no kv_caches: generate probes the
    signature and takes the padded path."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.config = inner.config

    def forward(self, input_ids):
        return self.inner(input_ids)


def test_arguments(mha_pair):
    _, tnet = mha_pair
    ids = _prompts(9, b=2, s=4)
    assert CACHE_BUCKET == 64
    for bad in ("int16", "float64", torch.int32):
        with pytest.raises(ValueError, match="cache_dtype"):
            generate(tnet, ids, 4, cache_dtype=bad)
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate(tnet, ids, np.array([1, 2, 3]))
    with pytest.raises(ValueError, match="eos_token_id"):
        generate(tnet, ids, 4, eos_token_id=[1, 2, 3])
    with pytest.raises(ValueError, match="sliding_window"):
        generate(tnet, ids, 4, cache_impl="rolling")
    with pytest.raises(ValueError, match="cache_impl"):
        generate(tnet, ids, 4, cache_impl="ring")
    for n in (0, -3):
        np.testing.assert_array_equal(generate(tnet, ids, n).numpy(), ids)
        np.testing.assert_array_equal(
            beam_search(tnet, ids, n, num_beams=3).numpy(), ids)
    i32 = ids.astype(np.int32)
    out = generate(tnet, i32, 3)
    assert out.dtype == torch.int32
    padded = generate(_NoCacheLM(tnet), ids, 5)
    np.testing.assert_array_equal(padded.numpy(),
                                  generate(tnet, ids, 5).numpy())
