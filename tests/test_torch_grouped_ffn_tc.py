"""The grouped-FFN kernels' routes (paddle_tpu_torch.kernels.moe) on the
CPU: the route rule the C entries share (``gg::route``, mirrored by
``grouped_ffn_route``), and the dx kernel's gw pass on the tensor-core
route held to the JAX reference bit for bit.

On the "tc" route the dx kernel writes gw = round_T(g ws) of the live
rows (zero on the dead) into a scratch before its products, because TMA
cannot scale rows while it loads; the reference computes the same value
inside its kernel (paddle_tpu/kernels/moe.py:413-416). Both are one f32
product per element rounded once to T, so they agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import moe as jmoe
from paddle_tpu_torch.kernels import moe

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("dtype,h,dff,route", [
    (BF16, 1024, 2816, "tc"),    # the ERNIE-MoE training shape
    (F16, 1024, 2816, "tc"),
    (BF16, 8, 8, "tc"),
    (F16, 96, 200, "tc"),
    (BF16, 256, 704, "tc"),      # the MoE cross-check model's widths
    (F32, 1024, 2816, "simt"),   # serving decode and prefill
    (F32, 8, 8, "simt"),
    (BF16, 100, 2816, "simt"),   # h: rows not a multiple of 16 bytes
    (BF16, 1024, 204, "simt"),   # dff likewise
    (F16, 100, 204, "simt"),
    (F16, 4, 8, "simt"),
])
def test_grouped_ffn_route(dtype, h, dff, route):
    assert moe.grouped_ffn_route(dtype, h, dff) == route


def _jax_gw(g, ws, counts, dtype):
    """gw as the reference's dx kernel computes it for each expert's rows
    (:413-416): f32 g times f32 ws where the row is live, else 0, cast to
    the input dtype."""
    rows = []
    for e, count in enumerate(counts):
        g32 = jnp.asarray(g[e]).astype(jnp.float32)
        keep = jmoe._row_mask(jnp.int32(count), 0, g.shape[1], g.shape[2])
        gw32 = jnp.where(keep, g32 * jnp.asarray(ws[e]).astype(jnp.float32),
                         jnp.float32(0.0))
        rows.append(np.asarray(gw32.astype(dtype)).astype(np.float32))
    return np.stack(rows)


@pytest.mark.parametrize("dtype,jdtype", [(BF16, jnp.bfloat16),
                                          (F16, jnp.float16)])
@pytest.mark.parametrize("counts", [[70, 0, 7, 64], [64, 64, 64, 64],
                                    [1, 33, 0, 0]])
def test_gw_plain_equals_jax_bit_for_bit(dtype, jdtype, counts):
    rng = np.random.default_rng(sum(counts) + len(str(dtype)))
    E, C, h = 4, 64, 48
    g = (rng.standard_normal((E, C, h)) * 3.0).astype(np.float32)
    ws = rng.uniform(0.0, 1.0, (E, C, 1)).astype(np.float32)
    gt = torch.from_numpy(g).to(dtype)
    want = _jax_gw(gt.float().numpy(), ws, counts, jdtype)
    got = moe.grouped_ffn_gw_plain(gt, torch.from_numpy(ws),
                                   torch.tensor(counts, dtype=torch.int32))
    assert got.dtype == dtype and got.shape == (E, C, h)
    assert np.array_equal(got.float().numpy(), want)
    dead = torch.arange(C)[None, :] >= torch.tensor(counts)[:, None]
    assert not got[dead].any()


def test_bwd_intermediates_use_the_gw_pass():
    """The plain backward's gw is grouped_ffn_gw_plain's, so the stage
    gate holds the kernel's products to the value its gw pass writes."""
    rng = np.random.default_rng(5)
    E, C, h, f = 2, 16, 32, 48
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    x, g = mk(E, C, h).to(BF16), mk(E, C, h).to(BF16)
    w1, w2 = (mk(E, h, f) * 0.1).to(BF16), (mk(E, f, h) * 0.1).to(BF16)
    b1, b2 = mk(E, 1, f) * 0.1, mk(E, 1, h) * 0.1
    ws = torch.from_numpy(rng.uniform(0.1, 1.0, (E, C, 1)).astype(np.float32))
    cnt = torch.tensor([16, 5], dtype=torch.int32)
    inter = moe.grouped_ffn_bwd_intermediates(x, w1, b1, w2, b2, ws, cnt, g)
    assert torch.equal(inter["gw"],
                       moe.grouped_ffn_gw_plain(g, ws, cnt).float())


@pytest.mark.parametrize("dtype,h,dff,gw_shape", [
    (BF16, 64, 136, (3, 40, 64)),
    (F32, 64, 136, (0,)),
    (BF16, 100, 136, (0,)),
])
def test_bwd_scratch_holds_gw_on_the_tc_route_only(dtype, h, dff, gw_shape):
    x = torch.zeros(3, 40, h, dtype=dtype)
    s = moe._bwd_scratch(x, dff)
    assert tuple(s["gw"].shape) == gw_shape and s["gw"].dtype == dtype
    assert tuple(s["ha"].shape) == tuple(s["dz"].shape) == (3, 40, dff)
    # the partials keep the 64-granular layout on both routes
    assert tuple(s["db1_part"].shape) == (3, 1, dff)
    assert tuple(s["dws_part"].shape) == (3, 40, -(-h // moe.COL_TILE))


def test_checked_operands_are_16_byte_aligned():
    """TMA needs 16-byte aligned operands: a contiguous view that starts
    mid-row is copied by the wrapper's checks, an aligned one is kept."""
    E, C, h, f = 2, 8, 16, 24
    buf = torch.arange(1 + E * C * h, dtype=torch.float32).to(BF16)
    x = buf[1:].view(E, C, h)
    assert x.data_ptr() % 16
    ops = [x, torch.ones(E, h, f, dtype=BF16), torch.zeros(E, 1, f),
           torch.ones(E, f, h, dtype=BF16), torch.zeros(E, 1, h),
           torch.ones(E, C, 1), torch.tensor([8, 3], dtype=torch.int32)]
    got = moe._check_cuda("t", *ops)
    assert all(t.data_ptr() % 16 == 0 for t in got)
    assert torch.equal(got[0], x) and got[0].data_ptr() != x.data_ptr()
    assert got[1].data_ptr() == ops[1].data_ptr()
