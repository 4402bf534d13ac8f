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
