"""The port's KV-cache attention and decode ops held to the JAX package on
the CPU, with the same weights: the dense caches (f32, bf16, int8) and the
rolling caches (f32, int8) of ``LlamaAttention._cached_attention`` with a
prefill shorter and longer than the window, then decode steps; the
``use_flash_attention=False`` forward; interleaved RoPE and user sin/cos
tables; and the incubate decode ops (``masked_multihead_attention``,
``variable_length_memory_efficient_attention``, ``paged_attention``,
``paged_write``, ``paged_quant_write``, ``block_multihead_attention``,
``blha_get_max_len``).

Tolerances. f32: logits and caches atol = rtol = 1e-4 (as the LLaMA
tests). bf16 caches: logits and written values atol = rtol = 2e-2 —
the JAX package rounds q and the softmax weights to bf16 before its
dots, the port reads the cache in f32 (a divergence logged in
ROADMAP.md), so the layers after the first write k / v that round
differently. int8: values equal except at rounding ties (|diff| <= 1, at
most 1 % of them), scales rtol 1e-6; logits atol = rtol = 1e-3 (a tie
moves one value by one quantum).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as jF
from paddle_tpu.jit.functional import get_buffers, get_frozen, get_params
from paddle_tpu.quantization.functional import kv_quantize_arrays as jquant
from paddle_tpu.text.generation import _model_forward as jax_forward
from paddle_tpu_torch import monitor
from paddle_tpu_torch.incubate.nn import functional as tF
from paddle_tpu_torch.quantization import kv_quantize_arrays

from test_torch_engine import torch_one_thread
from test_torch_llama import make_pair

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TOL = dict(atol=1e-4, rtol=1e-4)
WINDOW, LAYERS, KV, L = 6, 2, 2, 24
#: layout -> (cache dtype, rolling)
LAYOUTS = {"dense_f32": ("float32", False), "dense_bf16": ("bfloat16", False),
           "dense_int8": ("int8", False), "rolling_f32": ("float32", True),
           "rolling_int8": ("int8", True)}


def _np(t):
    if torch.is_tensor(t):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32)
                      if t.dtype == jnp.bfloat16 else t)


def _zero_caches(dtype, rolling, b, hd):
    """One layer's zeroed cache in numpy (f32 stand-in for bf16)."""
    n = WINDOW if rolling else L
    quant = dtype == "int8"
    vdt = np.int8 if quant else np.float32
    cache = [np.zeros((b, n, KV, hd), vdt), np.zeros((b, n, KV, hd), vdt)]
    if rolling:
        cache.append(np.full((n,), -1, np.int32))
    if quant:
        cache += [np.zeros((b, n, KV), np.float32)] * 2
    return cache


def _to_jax(cache, dtype):
    return tuple(jnp.asarray(a, jnp.bfloat16) if dtype == "bfloat16"
                 and a.dtype == np.float32 and a.ndim == 4 else jnp.asarray(a)
                 for a in cache)


def _to_torch(cache, dtype):
    return tuple(torch.tensor(a, dtype=torch.bfloat16)
                 if dtype == "bfloat16" and a.ndim == 4
                 else torch.tensor(a) for a in cache)


def _check_cache(tc, jc, dtype, what):
    for i, (t, j) in enumerate(zip(tc, jc)):
        t, j = _np(t), _np(j)
        name = f"{what} tensor {i}"
        if t.dtype == np.int8:
            diff = np.abs(t.astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, name
        elif t.dtype == np.int32:
            np.testing.assert_array_equal(t, j, err_msg=name)
        elif dtype == "int8":                       # the scales
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-12,
                                       err_msg=name)
        elif dtype == "bfloat16":
            np.testing.assert_allclose(t, j, rtol=2e-2, atol=2e-2,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(t, j, err_msg=name, **TOL)


@pytest.mark.parametrize("prefill", [4, 9], ids=["s_lt_C", "s_gt_C"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cached_attention_matches_jax(layout, prefill):
    """A prefill chunk (shorter or longer than the 6-token window), then
    three single-token steps and a 2-token chunk, through the dense or
    rolling cache: logits and every updated cache tensor match the JAX
    model's (GQA 4 -> 2 heads, window 6)."""
    dtype, rolling = LAYOUTS[layout]
    jnet, tnet, _ = make_pair(kv=KV, window=WINDOW, layers=LAYERS)
    b, hd = 2, 64 // 4
    st = (get_params(jnet), get_buffers(jnet), get_frozen(jnet))
    zero = [_zero_caches(dtype, rolling, b, hd) for _ in range(LAYERS)]
    jc = [_to_jax(c, dtype) for c in zero]
    tc = [_to_torch(c, dtype) for c in zero]
    rng = np.random.default_rng(7)
    ltol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=1e-3, rtol=1e-3) if dtype == "int8" else TOL
    counter = "kernels.decode." + ("rolling" if rolling else "dense")
    pos = 0
    for s in (prefill, 1, 1, 1, 2):
        ids = rng.integers(0, 64, (b, s)).astype(np.int32)
        jl, jc = jax_forward(jnet, st, jnp.asarray(ids), jc, jnp.int32(pos))
        before = monitor.counter(counter).get()
        with torch.no_grad():
            tl, new = tnet(torch.from_numpy(ids), kv_caches=tc,
                           cache_index=pos)
        assert monitor.counter(counter).get() - before == LAYERS
        # the caches are written in place: the same tensors come back
        assert all(x is y for c, n in zip(tc, new) for x, y in zip(c, n))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ltol)
        for layer, (t, j) in enumerate(zip(tc, jc)):
            _check_cache(t, j, dtype, f"step at {pos}, layer {layer}")
        pos += s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_dense_window_and_rolling_are_bit_equal(dtype):
    """With a window shorter than the dense cache, the dense layout attends
    the keys, shapes and order the rolling layout attends (the window's
    positions in order, then the chunk): the logits of a prefill past the
    window and of the steps after it are bit-equal, not merely close."""
    _, tnet, _ = make_pair(kv=KV, window=WINDOW, layers=LAYERS)
    b, hd = 2, 64 // 4
    caches = {rolling: [_to_torch(_zero_caches(dtype, rolling, b, hd), dtype)
                        for _ in range(LAYERS)] for rolling in (False, True)}
    rng = np.random.default_rng(13)
    pos = 0
    for s in (9, 1, 1, 3, 1):
        ids = torch.from_numpy(rng.integers(0, 64, (b, s)))
        with torch.no_grad():
            dense, _ = tnet(ids, kv_caches=caches[False], cache_index=pos)
            roll, _ = tnet(ids, kv_caches=caches[True], cache_index=pos)
        assert torch.equal(dense, roll), (pos, s)
        pos += s


def test_cache_routing_and_refusals():
    """2 / 4 tensors route dense, 3 / 5 with a 1-D third tensor rolling;
    a per-row index or a rolling cache without a window is refused."""
    _, tnet, _ = make_pair(kv=KV, layers=1)
    ids = torch.zeros((2, 1), dtype=torch.int64)
    dense = [(torch.zeros(2, 8, KV, 16), torch.zeros(2, 8, KV, 16))]
    with pytest.raises(ValueError, match="scalar cache_index"):
        tnet(ids, kv_caches=dense, cache_index=torch.tensor([0, 1]))
    rolling = [(torch.zeros(2, 4, KV, 16), torch.zeros(2, 4, KV, 16),
                torch.full((4,), -1, dtype=torch.int32))]
    with pytest.raises(ValueError, match="sliding_window"):
        tnet(ids, kv_caches=rolling, cache_index=0)
    with pytest.raises(ValueError, match="tuple of 2 or 4"):
        tnet(ids, kv_caches=[dense[0][:1]], cache_index=0)


@pytest.mark.parametrize("kv", [4, 2, 1])
def test_no_flash_forward_matches_jax(kv):
    """use_flash_attention=False without a window: the plain sdpa core over
    k / v repeated to the query heads (counter ``kernels.flash.sdpa.core``
    once a layer), logits as the JAX model's; with a window the flash path
    still runs."""
    jnet, tnet, _ = make_pair(kv=kv)
    jnet.config.use_flash_attention = False
    for lyr in jnet.llama.layers:
        lyr.self_attn.use_flash = False
    for lyr in tnet.llama.layers:
        lyr.self_attn.use_flash = False
    ids = np.random.default_rng(3).integers(0, 64, (2, 11)).astype(np.int32)
    want = np.asarray(jnet(paddle.to_tensor(ids)).numpy())
    core = monitor.counter("kernels.flash.sdpa.core").get()
    flash = monitor.counter("kernels.flash.fwd_plain").get()
    with torch.no_grad():
        got = tnet(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert monitor.counter("kernels.flash.sdpa.core").get() - core == 2
    assert monitor.counter("kernels.flash.fwd_plain").get() == flash
    tnet.llama.layers[0].self_attn.window = 5
    with torch.no_grad():
        tnet(torch.from_numpy(ids))
    assert monitor.counter("kernels.flash.fwd_plain").get() - flash == 1
    se = torch.zeros(1, 1, 11, 1, dtype=torch.int32)
    tnet.llama.layers[0].self_attn.window = None
    with pytest.raises(ValueError, match="use_flash_attention=True"):
        tnet(torch.from_numpy(ids), attn_mask_startend_row_indices=se)


# -- RoPE ------------------------------------------------------------------

def _rope_inputs(rng, b=2, s=7, h=3, d=8):
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k


def _rope_pair(q, k, **kw):
    jkw = {n: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
           for n, v in kw.items()}
    tkw = {n: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for n, v in kw.items()}
    jq, jk, jv = jF.fused_rotary_position_embedding(
        paddle.to_tensor(q), paddle.to_tensor(k), None, **jkw)
    tq, tk, tv = tF.fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k), None, **tkw)
    assert jv is None and tv is None
    return (np.asarray(jq.numpy()), np.asarray(jk.numpy())), \
        (tq.numpy(), tk.numpy())


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "interleaved"])
@pytest.mark.parametrize("positions", ["none", "shared", "per_row"])
def test_rope_angles_match_jax(neox, positions):
    rng = np.random.default_rng(5)
    q, k = _rope_inputs(rng)
    pid = {"none": None,
           "shared": np.arange(3, 10, dtype=np.int64),
           "per_row": rng.integers(0, 40, (2, 7)).astype(np.int64)}[positions]
    want, got = _rope_pair(q, k, position_ids=pid,
                           use_neox_rotary_style=neox)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "interleaved"])
@pytest.mark.parametrize("positions", ["none", "shared", "per_row"])
def test_rope_user_tables_match_jax(neox, positions):
    """User sin/cos tables: used as given (broadcast [1, s, 1, d]) without
    position_ids, indexed by them ([s_max, d], leading ones allowed)
    with."""
    rng = np.random.default_rng(6)
    q, k = _rope_inputs(rng)
    if positions == "none":
        sin = rng.standard_normal((1, 7, 1, 8)).astype(np.float32)
        cos = rng.standard_normal((1, 7, 1, 8)).astype(np.float32)
        pid = None
    else:
        sin = rng.standard_normal((1, 1, 20, 8)).astype(np.float32)
        cos = rng.standard_normal((1, 1, 20, 8)).astype(np.float32)
        pid = (np.arange(2, 9, dtype=np.int64) if positions == "shared"
               else rng.integers(0, 20, (2, 7)).astype(np.int64))
    want, got = _rope_pair(q, k, sin=sin, cos=cos, position_ids=pid,
                           use_neox_rotary_style=neox)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)


# -- the incubate decode ops -------------------------------------------------

@pytest.mark.parametrize("case", ["lengths", "mask", "bias_lengths"])
def test_masked_multihead_attention_matches_jax(case):
    rng = np.random.default_rng(8)
    b, h, L, d = 3, 2, 10, 8
    x = rng.standard_normal((b, 3 * h * d)).astype(np.float32)
    cache = rng.standard_normal((2, b, h, L, d)).astype(np.float32)
    kw = {}
    if case in ("lengths", "bias_lengths"):
        kw["sequence_lengths"] = np.array([[0], [4], [9]], np.int32)
    if case == "mask":
        kw["src_mask"] = rng.standard_normal((b, 1, 1, 6)).astype(np.float32)
    if case == "bias_lengths":
        kw["bias"] = rng.standard_normal((3, h, d)).astype(np.float32)
    jo, jc = jF.masked_multihead_attention(
        paddle.to_tensor(x), paddle.to_tensor(cache),
        **{n: paddle.to_tensor(v) for n, v in kw.items()})
    tcache = torch.from_numpy(cache.copy())
    to, tc = tF.masked_multihead_attention(
        torch.from_numpy(x), tcache,
        **{n: torch.from_numpy(v) for n, v in kw.items()})
    assert tc is tcache                                 # written in place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy()), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc.numpy()), **TOL)


def test_masked_multihead_attention_refusals():
    x = torch.zeros(2, 3 * 2 * 4)
    cache = torch.zeros(2, 2, 2, 5, 4)
    lens = torch.tensor([[1], [2]])
    for kw in (dict(cum_offsets=lens), dict(beam_cache_offset=lens),
               dict(rotary_tensor=x), dict(rotary_emb_dims=1),
               dict(qkv_out_scale=x), dict(out_scale=1.0)):
        with pytest.raises(NotImplementedError):
            tF.masked_multihead_attention(x, cache, sequence_lengths=lens,
                                          **kw)
    with pytest.raises(ValueError, match="requires cache_kv"):
        tF.masked_multihead_attention(x, sequence_lengths=lens)
    with pytest.raises(ValueError, match="sequence_lengths"):
        tF.masked_multihead_attention(x, cache)
    with pytest.raises(ValueError, match="max_seq_len"):
        tF.masked_multihead_attention(x, cache,
                                      sequence_lengths=torch.tensor([[1], [5]]))
    with pytest.raises(ValueError, match="max_seq_len"):
        tF.masked_multihead_attention(x, cache, src_mask=torch.zeros(2, 1, 1, 6))


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (True, True)])
def test_varlen_attention_matches_jax(causal, masked):
    rng = np.random.default_rng(9)
    B, H, S, T, D = 3, 2, 4, 7, 8
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((B, H, S, D), (B, H, T, D), (B, H, T, D)))
    sl = np.array([4, 2, 3], np.int32)
    kvl = np.array([7, 5, 6], np.int32)
    mask = rng.standard_normal((B, 1, S, T)).astype(np.float32) \
        if masked else None
    args = (q, k, v, sl, kvl)
    want = jF.variable_length_memory_efficient_attention(
        *map(paddle.to_tensor, args),
        mask=None if mask is None else paddle.to_tensor(mask), causal=causal)
    got = tF.variable_length_memory_efficient_attention(
        *map(torch.from_numpy, args),
        mask=None if mask is None else torch.from_numpy(mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), **TOL)


def _pool(rng, quant, nb=7, hkv=2, bs=4, d=8):
    kf = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    vf = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    if not quant:
        return kf, vf, None, None
    (kq, ks), (vq, vs) = (kv_quantize_arrays(torch.from_numpy(a))
                          for a in (kf, vf))
    return kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_attention_op_matches_jax(quant):
    """The incubate paged_attention (the plain paged_decode on CPU
    tensors, counted on ``kernels.decode.paged_plain``) against the JAX
    op, dead slot and GQA included."""
    rng = np.random.default_rng(10)
    kc, vc, ks, vs = _pool(rng, quant)
    q = rng.standard_normal((3, 4, 8)).astype(np.float32)
    bt = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0]], np.int32)
    cl = np.array([9, 5, 0], np.int32)
    arrays = (q, kc, vc, bt, cl)
    scales = {} if not quant else dict(k_scale=ks, v_scale=vs)
    want = jF.paged_attention(*map(paddle.to_tensor, arrays), scale=0.3,
                              **{n: paddle.to_tensor(a)
                                 for n, a in scales.items()})
    before = monitor.counter("kernels.decode.paged_plain").get()
    got = tF.paged_attention(*map(torch.from_numpy, arrays), scale=0.3,
                             **{n: torch.from_numpy(a)
                                for n, a in scales.items()})
    assert monitor.counter("kernels.decode.paged_plain").get() - before == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_writes_match_jax(quant):
    """paged_write / paged_quant_write (one token, then a 3-token chunk)
    write the pools in place, as the JAX ops write theirs."""
    rng = np.random.default_rng(11)
    kc, vc, ks, vs = _pool(rng, quant)
    bt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    pools_t = [torch.from_numpy(a.copy()) for a in (kc, vc, ks, vs)
               if a is not None]
    pools_j = [jnp.asarray(a) for a in (kc, vc, ks, vs) if a is not None]
    for shape, pos in (((2, 2, 8), [3, 10]), ((2, 3, 2, 8), [4, 0])):
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        pos = np.array(pos, np.int32)
        if quant:
            pj = jF.paged_quant_write(
                paddle.to_tensor(k), paddle.to_tensor(v),
                *[paddle.to_tensor(np.asarray(a)) for a in pools_j],
                paddle.to_tensor(bt), paddle.to_tensor(pos))
            pt = tF.paged_quant_write(torch.from_numpy(k),
                                      torch.from_numpy(v), *pools_t,
                                      torch.from_numpy(bt),
                                      torch.from_numpy(pos))
        else:
            pj = jF.paged_write(paddle.to_tensor(k), paddle.to_tensor(v),
                                *[paddle.to_tensor(np.asarray(a))
                                  for a in pools_j],
                                paddle.to_tensor(bt), paddle.to_tensor(pos))
            pt = tF.paged_write(torch.from_numpy(k), torch.from_numpy(v),
                                *pools_t, torch.from_numpy(bt),
                                torch.from_numpy(pos))
        assert all(a is b for a, b in zip(pt, pools_t))
        pools_j = [jnp.asarray(np.asarray(p.numpy())) for p in pj]
        for t, j in zip(pools_t, pools_j):
            t, j = t.numpy(), np.asarray(j)
            if t.dtype == np.int8:
                assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)


def test_block_attention_refused_and_max_len():
    with pytest.raises(NotImplementedError, match="paged_attention"):
        tF.block_multihead_attention(None)
    enc = np.array([3, 9, 0], np.int32)
    dec = np.array([5, 1, 2], np.int32)
    je, jd = jF.blha_get_max_len(paddle.to_tensor(enc), paddle.to_tensor(dec))
    te, td = tF.blha_get_max_len(torch.from_numpy(enc), torch.from_numpy(dec))
    assert te.tolist() == np.asarray(je.numpy()).tolist() == [9]
    assert td.tolist() == np.asarray(jd.numpy()).tolist() == [5]


def test_port_quantizer_matches_jax():
    """The int8 layouts above rest on one quantizer: the port's against
    the JAX package's on a chunk with an exact zero row."""
    x = np.random.default_rng(12).standard_normal((2, 5, 2, 8)).astype(
        np.float32)
    x[0, 1] = 0.0
    jq, js = jquant(jnp.asarray(x))
    tq, ts = kv_quantize_arrays(torch.from_numpy(x))
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
