"""The port's paged-KV decode (paddle_tpu_torch.kernels.paged_attention)
held to the JAX package's plain XLA reference ``paged_attention_arrays``
(the Pallas interpret tests are red on this tree, so they are not the
oracle), plus the paged writes and the int8 KV quantizer.

Tolerance: atol = rtol = 1e-4 on f32 outputs; int8 codes and scales
exact (both sides quantize the same f32 values the same way). On the CPU
the ``paged_decode`` wrapper runs the plain version; the CUDA kernel is
held to that plain version on the card (tests/test_torch_kernels_cuda.py
and chip_smoke.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401 — the JAX package's x64 setup
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.quantization.functional import kv_quantize_arrays as jax_kvq
from paddle_tpu.text.models.llama import _attend_cache as jax_attend
from paddle_tpu_torch import monitor
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.quantization import (kv_dequantize_arrays,
                                           kv_quantize_arrays)

TOL = dict(atol=1e-4, rtol=1e-4)


def _case(rng, b=5, h=4, hkv=2, d=16, bs=4, nblk=4, nb=24, ctx=None):
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    v = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    bt = rng.permutation(np.arange(1, nb))[:b * nblk].reshape(
        b, nblk).astype(np.int32)
    if ctx is None:
        # a dead slot, contexts on and off page boundaries, and a
        # context equal to the block table's capacity
        ctx = [0, 1, bs, bs + 3, nblk * bs][:b]
    return q, k, v, bt, np.asarray(ctx, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_plain_paged_decode_matches_jax(rep):
    rng = np.random.default_rng(rep)
    q, k, v, bt, cl = _case(rng, h=2 * rep, hkv=2)
    want = np.asarray(jpa.paged_attention_arrays(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(cl)))
    got = tpa.paged_attention_arrays(*_t(q, k, v, bt, cl)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any()                     # dead slot -> zeros


def test_int8_pool_matches_jax():
    rng = np.random.default_rng(7)
    q, k, v, bt, cl = _case(rng, h=4, hkv=2)
    jqk, jsk = jax_kvq(jnp.asarray(k))
    jqv, jsv = jax_kvq(jnp.asarray(v))
    tqk, tsk = kv_quantize_arrays(torch.from_numpy(k))
    tqv, tsv = kv_quantize_arrays(torch.from_numpy(v))
    np.testing.assert_array_equal(tqk.numpy(), np.asarray(jqk))
    np.testing.assert_array_equal(tsk.numpy(), np.asarray(jsk))
    np.testing.assert_allclose(
        kv_dequantize_arrays(tqk, tsk).numpy(),
        np.asarray(jqk, np.float32) * np.asarray(jsk)[..., None], **TOL)
    want = np.asarray(jpa.paged_attention_arrays(
        jnp.asarray(q), jqk, jqv, jnp.asarray(bt), jnp.asarray(cl),
        k_scale=jsk, v_scale=jsv))
    got = tpa.paged_attention_arrays(
        torch.from_numpy(q), tqk, tqv, *_t(bt, cl), k_scale=tsk,
        v_scale=tsv).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("window", [1, 3, 6])
def test_window_matches_jax_gather_path(window):
    """The decode window (the JAX package applies it on its gather path,
    llama.py:456-469, and inside the Pallas kernel): keys within
    ``window`` of the slot's own position ctx - 1."""
    rng = np.random.default_rng(window)
    q, k, v, bt, cl = _case(rng, h=4, hkv=2, ctx=[3, 7, 9, 16, 13])
    b, h, d = q.shape
    L = bt.shape[1] * k.shape[2]
    kk = jpa.gather_pages(jnp.asarray(k), jnp.asarray(bt))
    vv = jpa.gather_pages(jnp.asarray(v), jnp.asarray(bt))
    qpos = cl[:, None] - 1
    kpos = np.arange(L)[None]
    mask = (kpos <= qpos) & (qpos - kpos < window)
    want = np.asarray(jax_attend(jnp.asarray(q)[:, None], kk, vv,
                                 jnp.asarray(mask[:, None, :]), 2))[:, 0]
    got = tpa.paged_attention_arrays(*_t(q, k, v, bt, cl),
                                     window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_on_cpu_runs_plain_version():
    rng = np.random.default_rng(3)
    q, k, v, bt, cl = _case(rng)
    launches = tpa.paged_decode.launches
    before = monitor.counter("kernels.decode.paged_plain").get()
    got = tpa.paged_decode(*_t(q, k, v, bt, cl), window=5).numpy()
    want = tpa.paged_attention_arrays(*_t(q, k, v, bt, cl),
                                      window=5).numpy()
    np.testing.assert_array_equal(got, want)
    assert tpa.paged_decode.launches == launches      # no kernel on CPU
    assert monitor.counter("kernels.decode.paged_plain").get() == before + 1


@pytest.mark.parametrize("chunk", [1, 5])
def test_paged_write_matches_jax(chunk):
    """Single-token and chunked appends, with an idle lane at position
    -1 whose all-zero block-table row sends its write to scratch page
    0."""
    rng = np.random.default_rng(chunk)
    nb, hkv, bs, d = 12, 2, 4, 8
    kc = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    vc = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    bt = np.array([[3, 4, 5], [6, 7, 8], [0, 0, 0]], np.int32)
    pos = np.array([2, 6, -1], np.int32)
    shape = (3, hkv, d) if chunk == 1 else (3, chunk, hkv, d)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if chunk > 1:
        pos[2] = 0           # jax's eager capacity check reads max(pos)
    jk, jv = jpa.paged_write_arrays(jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(bt), jnp.asarray(pos))
    tk, tv = _t(kc, vc)
    out = tpa.paged_write_arrays(*_t(k, v), tk, tv, *_t(bt, pos))
    assert out[0] is tk and out[1] is tv                # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if chunk == 1:
        np.testing.assert_array_equal(tk.numpy()[0, :, bs - 1], k[2])


def test_paged_write_quant_matches_jax():
    rng = np.random.default_rng(11)
    nb, hkv, bs, d = 10, 2, 4, 8
    kc = np.zeros((nb, hkv, bs, d), np.int8)
    vc = np.zeros((nb, hkv, bs, d), np.int8)
    ks = np.zeros((nb, hkv, bs), np.float32)
    vs = np.zeros((nb, hkv, bs), np.float32)
    bt = np.array([[1, 2], [3, 4]], np.int32)
    pos = np.array([1, 3], np.int32)
    k = rng.standard_normal((2, 3, hkv, d)).astype(np.float32)
    v = rng.standard_normal((2, 3, hkv, d)).astype(np.float32)
    want = jpa.paged_write_quant_arrays(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(bt), jnp.asarray(pos))
    got = tpa.paged_write_quant_arrays(*_t(k, v, kc, vc, ks, vs, bt, pos))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_write_past_capacity_raises():
    kc = torch.zeros(4, 1, 4, 8)
    bt = torch.tensor([[1, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="capacity"):
        tpa.paged_write_arrays(torch.zeros(1, 1, 8), torch.zeros(1, 1, 8),
                               kc, kc.clone(), bt,
                               torch.tensor([8], dtype=torch.int32))


def test_kernel_requirements():
    assert tpa.paged_kernel_requirements(32, 32, 128, torch.bfloat16) is None
    assert tpa.paged_kernel_requirements(32, 8, 128, torch.int8) is None
    assert "float64" in tpa.paged_kernel_requirements(4, 4, 16,
                                                      torch.float64)
    assert "shared memory" in tpa.paged_kernel_requirements(
        64, 1, 512, torch.float32)
    assert "multiple" in tpa.paged_kernel_requirements(6, 4, 16,
                                                       torch.float32)


# -- the split decode kernel's schedule (csrc/paged_decode.cu) --------------

def _split_decode_emulation(q, k, v, bt, cl, window=None, ks=None, vs=None,
                            chunk=tpa.DECODE_CHUNK, tile=32, warps=4):
    """The split kernel's arithmetic in f64 numpy, schedule and all: the
    live range [max(0, ctx - window), min(ctx, capacity)) cut into chunks
    at absolute positions; in each chunk the warps' token groups (a
    quarter of every tile each at rep 1, half at rep 2, all of it at rep
    >= 4) keep their own online softmax (m, l, acc) over groups of 8
    tokens; the groups merge into the chunk's partial, and the combine
    rescales the partials to their common maximum in chunk order and
    divides by the summed l. Dead slots give zeros. Returns (out [b, h,
    d], chunks a slot ran [b])."""
    b, h, d = q.shape
    _, hkv, bs, _ = k.shape
    rep = h // hkv
    cap = bt.shape[1] * bs
    nrs = min(rep, warps)
    ntg = warps // nrs
    span = tile // ntg
    out = np.zeros((b, h, d))
    ran = np.zeros(b, np.int64)
    scale = 1.0 / math.sqrt(d)
    for s in range(b):
        lo = cl[s] - window if window and cl[s] > window else 0
        hi = min(cl[s], cap)
        if hi <= lo:
            continue
        chunks = range(lo // chunk, (hi - 1) // chunk + 1)
        ran[s] = len(chunks)

        def kv(t, g):
            page, off = bt[s, t // bs], t % bs
            kt, vt = k[page, g, off].astype(np.float64), \
                v[page, g, off].astype(np.float64)
            if ks is not None:
                kt, vt = kt * ks[page, g, off], vt * vs[page, g, off]
            return kt, vt
        for qh in range(h):
            g = qh // rep
            qv = q[s, qh].astype(np.float64) * scale
            parts = []
            for ch in chunks:
                c0 = ch * chunk
                ja, je = max(lo, c0) - c0, min(hi, c0 + chunk) - c0
                groups = []
                for tg in range(ntg):
                    m, l, acc = -np.inf, 0.0, np.zeros(d)
                    toks = [j for t0 in range(0, chunk, tile)
                            for j in range(t0 + tg * span,
                                           t0 + (tg + 1) * span)
                            if ja <= j < je]
                    for i in range(0, len(toks), 8):
                        grp = [kv(c0 + j, g) for j in toks[i:i + 8]]
                        sc = np.array([qv @ kt for kt, _ in grp])
                        mx = max(m, sc.max())
                        alpha = math.exp(m - mx) if m > -np.inf else 0.0
                        p = np.exp(sc - mx)
                        l = l * alpha + p.sum()
                        acc = acc * alpha + sum(pi * vt for pi, (_, vt)
                                                in zip(p, grp))
                        m = mx
                    groups.append((m, l, acc))
                mm = max(gm for gm, _, _ in groups)
                w = [math.exp(gm - mm) if gm > -np.inf else 0.0
                     for gm, _, _ in groups]
                parts.append((mm, sum(wi * gl for wi, (_, gl, _)
                                      in zip(w, groups)),
                              sum(wi * ga for wi, (_, _, ga)
                                  in zip(w, groups))))
            mm = max(pm for pm, _, _ in parts)
            w = [math.exp(pm - mm) for pm, _, _ in parts]
            out[s, qh] = sum(wi * pa for wi, (_, _, pa) in zip(w, parts)) \
                / sum(wi * pl for wi, (_, pl, _) in zip(w, parts))
    return out, ran


def _chunk_edge_case(rng, rep, hkv=2, d=16, bs=16, nblk=9):
    """Contexts at the chunk's edges (1, chunk - 1, chunk, chunk + 1,
    two chunks and one token), a dead slot and a full table."""
    c = tpa.DECODE_CHUNK
    return _case(rng, b=7, h=hkv * rep, hkv=hkv, d=d, bs=bs, nblk=nblk,
                 nb=7 * nblk + 1,
                 ctx=[1, c - 1, c, c + 1, 2 * c + 1, 0, nblk * bs])


@pytest.mark.parametrize("rep", [1, 4, 8])
def test_split_decode_schedule_matches_jax(rep):
    """The split kernel's schedule (chunked partials and their combine,
    the warps' token groups) against the JAX package's plain decode, at
    contexts on either side of the chunk edges; f64 emulation against
    f32 XLA: the module's 1e-4 tolerance."""
    rng = np.random.default_rng(40 + rep)
    q, k, v, bt, cl = _chunk_edge_case(rng, rep)
    want = np.asarray(jpa.paged_attention_arrays(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(cl)))
    got, ran = _split_decode_emulation(q, k, v, bt, cl)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[5].any()                              # dead slot
    c = tpa.DECODE_CHUNK
    assert ran.tolist() == [-(-n // c) for n in cl.tolist()]
    assert tpa.paged_decode_chunks(bt.shape[1], k.shape[2]) == \
        -(-bt.shape[1] * k.shape[2] // c)


@pytest.mark.parametrize("window", [10, tpa.DECODE_CHUNK + 7])
def test_split_decode_schedule_window_cuts_a_chunk(window):
    """A window whose left edge falls inside a chunk: the chunks left of
    it are not run, the cut chunk runs from the window's edge; held to
    the JAX gather path with the window's mask (llama.py:456-469)."""
    rng = np.random.default_rng(window)
    q, k, v, bt, cl = _chunk_edge_case(rng, 2)
    b, h, d = q.shape
    L = bt.shape[1] * k.shape[2]
    kk = jpa.gather_pages(jnp.asarray(k), jnp.asarray(bt))
    vv = jpa.gather_pages(jnp.asarray(v), jnp.asarray(bt))
    qpos = cl[:, None] - 1
    kpos = np.arange(L)[None]
    mask = (kpos <= qpos) & (qpos - kpos < window)
    want = np.array(jax_attend(jnp.asarray(q)[:, None], kk, vv,
                               jnp.asarray(mask[:, None, :]), 2))[:, 0]
    want[cl == 0] = 0.0                   # the kernel's dead-slot zeros
    got, ran = _split_decode_emulation(q, k, v, bt, cl, window=window)
    np.testing.assert_allclose(got, want, **TOL)
    c = tpa.DECODE_CHUNK
    lo = np.where(cl > window, cl - window, 0)
    assert ran.tolist() == [0 if n == 0 else (n - 1) // c - a // c + 1
                            for n, a in zip(cl.tolist(), lo.tolist())]


def test_split_decode_schedule_int8_scales():
    """int8 pools: the scales fold into the scores and the value weights
    (s = ks (q . k_int), p vs v_int), against the JAX package's plain
    decode on the same codes and scales."""
    rng = np.random.default_rng(9)
    q, k, v, bt, cl = _chunk_edge_case(rng, 4)
    jqk, jsk = jax_kvq(jnp.asarray(k))
    jqv, jsv = jax_kvq(jnp.asarray(v))
    want = np.asarray(jpa.paged_attention_arrays(
        jnp.asarray(q), jqk, jqv, jnp.asarray(bt), jnp.asarray(cl),
        k_scale=jsk, v_scale=jsv))
    got, _ = _split_decode_emulation(
        q, np.asarray(jqk), np.asarray(jqv), bt, cl,
        ks=np.asarray(jsk), vs=np.asarray(jsv))
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_smem_mirror_follows_the_pool_dtype():
    """The shared-memory mirror of the split kernel: K and V of one chunk
    in the pool's own dtype (a bf16 pool stages half an f32 pool's
    bytes), plus the warps' merge rows, which grow with rep."""
    c = tpa.DECODE_CHUNK
    f32 = tpa.paged_decode_smem_bytes(1, 128, 4)
    bf16 = tpa.paged_decode_smem_bytes(1, 128, 2)
    assert f32 - bf16 == 2 * c * 128 * 2
    assert tpa.paged_decode_smem_bytes(8, 128, 2) > bf16
    # int8 rows of d 40 pad to 48 bytes (16-byte runs)
    assert tpa.paged_decode_smem_bytes(1, 40, 1) == \
        2 * c * 48 + 2 * c * 4 + 8 * c + 4 * 4 * 42 + 32
    assert "head_dim 320" in tpa.paged_kernel_requirements(4, 4, 320,
                                                           torch.float32)


def test_checked_operands_are_cast_only_where_needed():
    """``_check_cuda`` hands the C entry f32 q and int32 tables as they
    are when they already are contiguous tensors of those dtypes (no
    call on the decode tick's host path), and a contiguous cast copy
    otherwise, with the same values."""
    rng = np.random.default_rng(3)
    b, h, d, bs = 3, 4, 8, 16
    pool = torch.from_numpy(rng.standard_normal((7, 2, bs, d))
                            .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    bt = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    cl = torch.tensor([5, 0, 32], dtype=torch.int32)
    qf, btc, clc = tpa._check_cuda(q, pool, pool, bt, cl, None, None)
    assert qf is q and btc is bt and clc is cl
    q16 = q.to(torch.bfloat16).transpose(0, 1).contiguous().transpose(0, 1)
    qf, btc, clc = tpa._check_cuda(q16, pool, pool, bt.long(),
                                   cl.long(), None, None)
    assert qf.dtype == torch.float32 and qf.is_contiguous()
    assert torch.equal(qf, q16.float())
    assert btc.dtype == clc.dtype == torch.int32
    assert torch.equal(btc, bt) and torch.equal(clc, cl)
