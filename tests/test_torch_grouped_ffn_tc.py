"""The grouped-FFN kernels' routes (paddle_tpu_torch.kernels.moe) on the
CPU: the route rule the C entries share (``gg::route``, mirrored by
``grouped_ffn_route``), the dx kernel's gw pass on the tensor-core
route held to the JAX reference bit for bit, and the dw kernel's
tensor-core arithmetic emulated against ``jax.vjp`` of the reference.

On the "tc" route the dw kernel's products sum over rows, 64 a stage,
both operands MN-major in shared memory in the 128B swizzle; the rows of
the last stage past the expert's count lie inside the buffer and may hold
NaN, so the kernel zeroes them, whole 128-byte lines of each slab, before
that stage's products. The emulation below shows that zeroing a line
zeroes exactly one row under the swizzle, and that the staged sums with
the tail zeroed match the reference where a multiply by a mask would
give NaN.

On the "tc" route the dx kernel writes gw = round_T(g ws) of the live
rows (zero on the dead) into a scratch before its products, because TMA
cannot scale rows while it loads; the reference computes the same value
inside its kernel (paddle_tpu/kernels/moe.py:413-416). Both are one f32
product per element rounded once to T, so they agree exactly.
"""
import jax
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


@pytest.mark.parametrize("gw_shape", [(0,), (3, 40, 32)])
def test_dw_launch_refuses_tc_scratch_without_gw(gw_shape):
    """The dw entry takes the dx entry's route (bf16, h and dff multiples
    of 8: tc) and there reads the dx entry's gw scratch [E, C, h]: the
    wrapper raises before any launch when the scratch holds none."""
    E, C, h, f = 3, 40, 64, 136
    assert moe.grouped_ffn_route(BF16, h, f) == "tc"
    x = torch.zeros(E, C, h, dtype=BF16)
    ops = (x, torch.zeros(E, h, f, dtype=BF16), torch.zeros(E, 1, f),
           torch.zeros(E, f, h, dtype=BF16), torch.zeros(E, 1, h),
           torch.zeros(E, C, 1), torch.zeros(E, dtype=torch.int32), x)
    s = moe._bwd_scratch(x, f)
    s["gw"] = torch.empty(gw_shape, dtype=BF16)
    dw1, dw2 = torch.empty_like(ops[1]), torch.empty_like(ops[3])
    with pytest.raises(ValueError, match="gw scratch"):
        moe._bwd_dw_launch(ops, s, dw1, torch.empty(E, 1, f), dw2)


#: bytes of a 128-byte swizzle line and of a 64 x 64 16-bit slab
LINE, SLAB = 128, 64 * 128


def _swizzle128(nbytes):
    """The shared-memory byte each byte of a tile lands on under
    CU_TENSOR_MAP_SWIZZLE_128B (TMA's and wgmma's 128B swizzle): the
    16-byte chunk j of 128-byte line r goes to chunk j ^ (r % 8) of the
    same line."""
    off = np.arange(nbytes)
    return off ^ (((off >> 7) & 7) << 4)


def _store(tile):
    """A [64, 64] 16-bit tile (one row a line) as its swizzled bytes."""
    raw = np.ascontiguousarray(tile).view(np.uint8).reshape(-1)
    phys = np.empty_like(raw)
    phys[_swizzle128(raw.size)] = raw
    return phys


def _load(phys, shape):
    return phys[_swizzle128(phys.size)].view(np.uint16).reshape(shape)


def test_swizzle128_permutes_chunks_within_each_line():
    sw = _swizzle128(SLAB)
    for r in range(SLAB // LINE):
        line = sw[r * LINE:(r + 1) * LINE]
        assert sorted(line) == list(range(r * LINE, (r + 1) * LINE))


@pytest.mark.parametrize("row", [0, 1, 7, 8, 37, 63])
def test_zeroing_a_line_of_an_mn_major_slab_zeroes_one_k_row(row):
    """An MN-major slab holds one K row (64 M or N values, 128 bytes) a
    line: zeroing line ``row`` in shared memory zeroes exactly K row
    ``row`` and nothing else. Zeroing a chunk at the same place in every
    line instead hits other columns in other rows."""
    rng = np.random.default_rng(row)
    tile = rng.integers(1, 2 ** 16, (64, 64), dtype=np.uint16)
    phys = _store(tile)
    phys[row * LINE:(row + 1) * LINE] = 0
    back = _load(phys, tile.shape)
    assert not back[row].any()
    assert np.array_equal(np.delete(back, row, 0), np.delete(tile, row, 0))
    col = _store(tile)
    for r in range(64):
        col[r * LINE:r * LINE + 16] = 0      # chunk 0 of every line
    hit = _load(col, tile.shape) == 0
    assert [int(np.flatnonzero(hit[r])[0]) // 8 for r in range(8)] == \
        list(range(8))


def _staged_dw(a, b, count, tail):
    """The tc dw product of one expert, as the kernel runs it: the depth
    over rows in 64-row stages up to ceil(count / 64) * 64 (rows past the
    buffer read as zeros); each stage's A [64, M] and B [64, N] tiles
    stored as 64-column swizzled slabs; with ``tail`` = "zero", K rows
    count..end of the last stage zeroed as whole lines of every slab (the
    kernel's zero_k_rows), with "mask" multiplied by a 0/1 row mask
    instead; f32 sums -> [M, N]."""
    C, M = a.shape
    N = b.shape[1]
    acc = torch.zeros(M, N)
    for k0 in range(0, -(-count // 64) * 64, 64):
        tiles = []
        for op in (a, b):
            t = torch.zeros(64, op.shape[1], dtype=op.dtype)
            t[:min(64, C - k0)] = op[k0:k0 + 64]
            bits = t.view(torch.int16).numpy().view(np.uint16)
            slabs = []
            for c0 in range(0, bits.shape[1], 64):
                phys = _store(bits[:, c0:c0 + 64])
                if tail == "zero" and k0 + 64 > count:
                    phys[(count - k0) * LINE:] = 0
                slabs.append(_load(phys, (64, 64)))
            t = torch.from_numpy(np.concatenate(slabs, 1).view(np.int16)) \
                .view(op.dtype).float()
            if tail == "mask":
                t = t * (torch.arange(k0, k0 + 64) < count).float()[:, None]
            tiles.append(t)
        acc += tiles[0].T @ tiles[1]
    return acc


@pytest.mark.parametrize("dtype", [BF16, F16])
def test_dw_stages_with_zeroed_tail_match_jax_vjp(dtype):
    """dw1 = x^T dz_T and dw2 = ha^T gw by the staged emulation, on
    buffers whose dead rows hold NaN (x is the caller's dispatch buffer,
    ha and dz scratch the dx kernel leaves unwritten there), at counts 0,
    1, 63, 64, 65 and C: with the tail zeroed they match ``jax.vjp`` of
    the JAX reference within the bf16 bar of the port's MoE tests (2e-2 of
    the largest gradient; the intermediates are rounded to T); a mask
    multiplied in instead gives NaN (0 * NaN) for every expert whose last
    stage holds dead rows inside the buffer."""
    from tests.test_torch_moe_kernel import ORDER, _jax_ref, _operands
    E, C, h, f = 6, 150, 64, 128
    counts = [0, 1, 63, 64, 65, C]
    ops = _operands(31, E, C, h, f)
    _, wgrads = _jax_ref(ops, counts, "gelu")
    t = {n: torch.from_numpy(v) for n, v in ops.items()}
    for n in ("x", "w1", "w2", "g"):
        t[n] = t[n].to(dtype)
    cnt = torch.tensor(counts, dtype=torch.int32)
    inter = moe.grouped_ffn_bwd_intermediates(
        *(t[n] for n in ORDER), cnt, t["g"])
    dead = ~moe._row_mask(cnt, C, "cpu")[..., 0]
    x, ha, dz = (v.to(dtype).clone() for v in (t["x"], inter["ha"],
                                                 inter["dz"]))
    for v in (x, ha, dz):
        v[dead] = float("nan")
    gw = inter["gw"].to(dtype)
    for tail in ("zero", "mask"):
        got = [torch.stack([_staged_dw(a[e], b[e], counts[e], tail)
                            for e in range(E)])
               for a, b in ((x, dz), (ha, gw))]
        # a last stage with dead rows inside the buffer
        partial = [e for e, c in enumerate(counts) if c % 64 and c < C]
        if tail == "mask":
            for d in got:
                assert all(bool(d[e].isnan().any()) for e in partial)
            continue
        for d, want in zip(got, (wgrads[1], wgrads[3])):
            assert bool(torch.isfinite(d).all())
            err = float(np.abs(d.to(dtype).float().numpy() - want).max())
            assert err <= 2e-2 * float(np.abs(want).max()), err
            assert not d[0].any()
