"""The port's CUDA kernels held to their plain PyTorch versions on the
card, at small shapes that cover the edges (dead slots, ragged page and
tile edges, GQA, windows, every pool dtype). They need an NVIDIA GPU
and nvcc, so they skip elsewhere; on the card run

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

(chip_smoke.py repeats the comparison at the serving shapes.) The last
tests hold paddle.vision's detection ops and a resnet18 train_batch on
the card to their CPU path (no kernel of the port: plain PyTorch on
either device), and so do the tests after them: ``text.viterbi_decode``
and a tiny BERT-CRF, the ``fft`` transforms, ``stft`` / ``istft`` and
the audio features, message passing, segment pooling and a GCN layer on
both aggregation routes, the sparse convolution, batch norm and pooling,
the distributions' densities, entropies and KLs with their gradients,
and samples drawn on the card. The last two hold the flash custom ops of
``jit.to_static``'s graphs to the plain versions, and a compiled masked
attention layer to the wgmma route and to its eager gradients.
Tolerances: 1e-4 relative to the output's scale for f32, 1e-2 for half
precision outputs (the kernels accumulate in f32; the plain versions sum
in another order).
"""
import math

import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.quantization import kv_quantize_arrays

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol):
    err = float((got.float() - want.float()).abs().max())
    assert err <= rtol * max(1.0, float(want.abs().max())), err


def test_probe_runs(dev):
    for name in _build.SOURCES:
        out = _build.probe(name, dev)
        assert torch.equal(out.flatten()[:3].cpu(), torch.tensor([0., 2., 4.]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int8])
@pytest.mark.parametrize("rep,window,d,bs", [(1, None, 64, 16),
                                             (4, None, 128, 8),
                                             (2, 5, 40, 7),
                                             (8, 33, 256, 32)])
def test_paged_decode_matches_plain(dev, dtype, rep, window, d, bs):
    g = torch.Generator(device=dev).manual_seed(rep * 100 + bs)
    b, hkv, nblk = 6, 2, 5
    nb = b * nblk + 1
    ctx = torch.tensor([0, 1, bs, bs + 1, nblk * bs, nblk * bs + 9],
                       device=dev)
    bt = (torch.randperm(nb - 1, generator=g, device=dev) + 1).reshape(
        b, nblk).to(torch.int32)
    q = torch.randn(b, hkv * rep, d, generator=g, device=dev)
    kf = torch.randn(nb, hkv, bs, d, generator=g, device=dev)
    vf = torch.randn(nb, hkv, bs, d, generator=g, device=dev)
    ks = vs = None
    if dtype == torch.int8:
        (kc, ks), (vc, vs) = kv_quantize_arrays(kf), kv_quantize_arrays(vf)
    else:
        kc, vc = kf.to(dtype), vf.to(dtype)
    launches = pa.paged_decode.launches
    got = pa.paged_decode(q, kc, vc, bt, ctx, window=window, k_scale=ks,
                          v_scale=vs)
    torch.cuda.synchronize()
    assert pa.paged_decode.launches == launches + 1
    want = pa.paged_attention_arrays(q, kc, vc, bt, ctx, window=window,
                                     k_scale=ks, v_scale=vs)
    _close(got, want, 1e-4)
    assert not got[0].any()                       # dead slot: zeros


def _decode_counts():
    from paddle_tpu_torch import monitor
    return {r: monitor.counter(f"kernels.decode.paged_cuda_{r}").get()
            for r in ("split", "single")}


#: the serving geometries: (h, h_kv, d) of LLaMA (bf16 pool) and ERNIE-MoE
#: (f32 pool), 128-token pages, 3 pages a slot
_SERVING_DECODE = {"llama": (32, 32, 128), "ernie_moe": (16, 16, 64)}
#: contexts 0-320 on either side of the 64-token chunk edges
_EDGE_CONTEXTS = [0, 1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 255, 256,
                  257, 319, 320]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int8])
@pytest.mark.parametrize("geometry", sorted(_SERVING_DECODE))
@pytest.mark.parametrize("rep,window", [(1, None), (1, 100), (4, None),
                                        (8, 70)])
def test_paged_decode_split_at_serving_geometry(dev, dtype, geometry, rep,
                                                window):
    """The split kernel at both serving geometries (GQA: the query heads
    kept, the kv heads divided by rep), contexts across the chunk edges
    and a dead slot: within the f32 gate of its plain version, dead slots
    zero, and the C entry reports DECODE_CHUNK-token chunks, as many a
    (kv head, slot) as the table holds, which covers the longest
    context; the call counts once, on the split counter."""
    h, hkv, d = _SERVING_DECODE[geometry]
    hkv //= rep
    bs, nblk = 128, 3
    b = len(_EDGE_CONTEXTS)
    g = torch.Generator(device=dev).manual_seed(rep * 7 + d)
    ctx = torch.tensor(_EDGE_CONTEXTS, device=dev)
    nb = b * nblk + 1
    bt = (torch.randperm(nb - 1, generator=g, device=dev) + 1).reshape(
        b, nblk).to(torch.int32)
    q = torch.randn(b, h, d, generator=g, device=dev)
    kf = torch.randn(nb, hkv, bs, d, generator=g, device=dev)
    vf = torch.randn(nb, hkv, bs, d, generator=g, device=dev)
    ks = vs = None
    if dtype == torch.int8:
        (kc, ks), (vc, vs) = kv_quantize_arrays(kf), kv_quantize_arrays(vf)
    else:
        kc, vc = kf.to(dtype), vf.to(dtype)
    qf, btc, cl = pa._check_cuda(q, kc, vc, bt, ctx, ks, vs)
    out = torch.empty(b, h, d, device=dev)
    scratch = pa.decode_scratch(qf, btc, bs)
    chunk, nch = pa._decode_launch(qf, kc, vc, btc, cl, out, scratch,
                                   d ** -0.5, window, ks, vs)
    assert chunk == pa.DECODE_CHUNK
    assert nch == -(-nblk * bs // chunk) == pa.paged_decode_chunks(nblk, bs)
    assert nch >= -(-int(ctx.max()) // chunk)
    counts, launches = _decode_counts(), pa.paged_decode.launches
    got = pa.paged_decode(q, kc, vc, bt, ctx, window=window, k_scale=ks,
                          v_scale=vs)
    torch.cuda.synchronize()
    assert pa.paged_decode.launches == launches + 1
    assert _decode_counts() == {"split": counts["split"] + 1,
                                "single": counts["single"]}
    want = pa.paged_attention_arrays(q, kc, vc, bt, ctx, window=window,
                                     k_scale=ks, v_scale=vs)
    _close(got, want, 1e-4)
    _close(out, want, 1e-4)
    assert not got[0].any()
    assert torch.equal(got, out)        # no atomics: the same bits


def test_paged_decode_single_chunk_writes_directly(dev):
    """A block table of one chunk (2 pages of 16): the kernel writes the
    output itself, the C entry reports one chunk, and the call counts on
    the single counter."""
    b, h, d, bs, nblk = 4, 8, 64, 16, 2
    g = torch.Generator(device=dev).manual_seed(5)
    ctx = torch.tensor([0, 1, 17, 32], device=dev)
    bt = (torch.arange(b * nblk, device=dev) + 1).reshape(b, nblk).to(
        torch.int32)
    q = torch.randn(b, h, d, generator=g, device=dev)
    kc = torch.randn(b * nblk + 1, h, bs, d, generator=g, device=dev)
    vc = torch.randn(b * nblk + 1, h, bs, d, generator=g, device=dev)
    counts = _decode_counts()
    got = pa.paged_decode(q, kc, vc, bt, ctx)
    torch.cuda.synchronize()
    assert _decode_counts() == {"split": counts["split"],
                                "single": counts["single"] + 1}
    _close(got, pa.paged_attention_arrays(q, kc, vc, bt, ctx), 1e-4)
    assert not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,sq,sk,h,hkv,d,causal,window", [
    (2, 64, 64, 4, 4, 128, True, None),
    (1, 100, 77, 4, 2, 80, True, None),         # sq > sk: empty rows
    (2, 37, 129, 6, 3, 64, True, 20),
    (1, 70, 70, 2, 1, 32, False, None),
    (1, 65, 65, 2, 2, 256, True, 7),
    (1, 20, 33, 2, 2, 30, False, None),         # head dim not /4
])
def test_flash_fwd_matches_plain(dev, dtype, B, sq, sk, h, hkv, d, causal,
                                 window):
    g = torch.Generator(device=dev).manual_seed(sq + sk + d)
    q = torch.randn(B, sq, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(B, sk, hkv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(B, sk, hkv, d, generator=g, device=dev).to(dtype)
    launches = fa.flash_fwd.launches
    got = fa.flash_fwd(q, k, v, causal, d ** -0.5, window)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == launches + 1
    want = fa.flash_plain(q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                          v.transpose(1, 2).float(), causal, d ** -0.5,
                          window).transpose(1, 2)
    _close(got, want, 1e-4 if dtype == torch.float32 else 1e-2)


def test_flash_fwd_reads_strided_inputs(dev):
    """q/k/v as views of one fused [B, S, 3, H, D] projection: no copy,
    same answer."""
    qkv = torch.randn(2, 48, 3, 4, 64, device=dev)
    q, k, v = qkv.unbind(2)
    got = fa.flash_fwd(q, k, v, True, 0.125)
    want = fa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                        True, 0.125)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _doc_bands(s, bounds, B=1, h_se=1):
    """Normalized causal document-mask bands [B, h_se, 4, s]: key j of
    document [lo, hi) is masked for rows >= hi."""
    raw = torch.zeros(B, h_se, s, 1, dtype=torch.int32)
    for lo, hi in bounds:
        raw[:, :, lo:hi, 0] = hi
    return fa._normalize_startend(raw, s, s, True)


def _random_bands(g, s, C, causal, B, h_se):
    start = torch.randint(0, s, (B, h_se, s, 1), generator=g)
    cols = [start, torch.clamp(start + torch.randint(
        1, s, (B, h_se, s, 1), generator=g), max=s)]
    if C == 4:
        ut = torch.randint(0, s // 2, (B, h_se, s, 1), generator=g)
        cols += [ut, torch.clamp(ut + 9, max=s)]
    return fa._normalize_startend(torch.cat(cols, -1), s, s, causal)


# (B, sq, sk, h, hkv, d, causal, window, mask)
_TRAIN_CASES = {
    "ragged": (2, 70, 70, 4, 4, 128, True, None, None),
    "sq_lt_sk": (1, 37, 129, 4, 2, 64, True, None, None),
    "empty_rows": (1, 100, 77, 4, 2, 64, True, None, None),
    "gqa_rep4": (2, 96, 96, 8, 2, 128, True, None, None),
    "window": (1, 130, 130, 4, 2, 64, True, 20, None),
    "full_d80": (1, 45, 45, 2, 1, 80, False, None, None),
    "doc_mask_skips": (2, 300, 300, 4, 2, 128, True, None, "doc"),
    "bands_c2_causal": (2, 90, 90, 4, 2, 64, True, None, "c2"),
    "bands_c4_full": (1, 90, 90, 4, 4, 64, False, None, "c4"),
}


def _train_inputs(dev, name, dtype, cases=_TRAIN_CASES):
    B, sq, sk, h, hkv, d, causal, window, mask = cases[name]
    g = torch.Generator().manual_seed(len(name) * 7 + d)
    q, k, v, do = (torch.randn(B, s_, hh, d, generator=g).to(dev, dtype)
                   for s_, hh in ((sq, h), (sk, hkv), (sk, hkv), (sq, h)))
    se = None
    if mask == "doc":
        se = _doc_bands(sq, [(0, 100), (100, 228), (228, sq)])
    elif mask == "doc4":
        se = _doc_bands(sq, [(0, 128), (128, 320), (320, 384), (384, sq)])
    elif mask is not None:
        se = _random_bands(g, sq, 2 if mask == "c2" else 4, causal, B,
                           hkv if mask == "c2" else 1)
    if se is not None:
        se = se.to(dev)
    return q, k, v, do, causal, window, se


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(_TRAIN_CASES))
def test_flash_fwd_lse_and_bwd_match_plain(dev, dtype, name):
    """The forward with logsumexp and both backward kernels against the
    plain versions on the same inputs (the plain ones in f32 from the
    same rounded inputs, so only the output rounding differs)."""
    q, k, v, do, causal, window, se = _train_inputs(dev, name, dtype)
    scale = q.shape[-1] ** -0.5
    t = lambda x: x.transpose(1, 2).float()
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    n_fwd = fa.flash_fwd.launches
    out, lse = fa.flash_fwd(q, k, v, causal, scale, window, se,
                            want_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == n_fwd + 1
    want, want_lse = fa.flash_plain(t(q), t(k), t(v), causal, scale, window,
                                    se, return_lse=True)
    _close(out, want.transpose(1, 2), rtol)
    # lse: NEG_INF rows exactly, the rest within f32 rounding
    dead = want_lse <= fa.ROW_INVALID_LSE
    assert torch.equal(lse <= fa.ROW_INVALID_LSE, dead)
    _close(lse[~dead], want_lse[~dead], 1e-5)

    o = want.transpose(1, 2).to(dtype)
    n_dq, n_dkv = fa.flash_bwd.launches_dq, fa.flash_bwd.launches_dkv
    got = fa.flash_bwd(q, k, v, o, want_lse, do, causal, scale, window, se)
    torch.cuda.synchronize()
    assert (fa.flash_bwd.launches_dq, fa.flash_bwd.launches_dkv) == (
        n_dq + 1, n_dkv + 1)
    ref = fa.flash_bwd_plain(t(q), t(k), t(v), t(o), want_lse, t(do), causal,
                             scale, window, se)
    for g_, r_, n in zip(got, ref, ("dq", "dk", "dv")):
        assert g_.dtype == dtype and g_.shape == r_.transpose(1, 2).shape, n
        _close(g_, r_.transpose(1, 2), rtol)


def _route_counts():
    from paddle_tpu_torch import monitor
    return {n: monitor.counter(f"kernels.flash.{n}").get()
            for n in ("fwd_cuda_tc", "fwd_cuda_tf32x3", "fwd_cuda_simt",
                      "dq_cuda_tc", "dq_cuda_simt", "dkv_cuda_tc",
                      "dkv_cuda_simt")}


def _route_delta(before):
    return {n: v - before[n] for n, v in _route_counts().items() if
            v != before[n]}


#: the route of every existing bf16 case above: 16-bit, head dim a
#: multiple of 8, 16-byte aligned rows -> tc; head dim 30 -> simt
_FWD_ROUTES = {128: "tc", 80: "tc", 64: "tc", 32: "tc", 256: "tc",
               30: "simt"}
#: the tc route's launches of one bf16 forward and backward pass
_TC_PASS = {"fwd_cuda_tc": 1, "dq_cuda_tc": 1, "dkv_cuda_tc": 1}


def test_flash_routes_of_existing_bf16_cases(dev):
    """Which route each existing bf16 case takes, from the per-route
    counters: the forward cases by head dim, every training case (head
    dims 64, 80 and 128) on tc for the forward, dQ and dK/dV."""
    for d, route in _FWD_ROUTES.items():
        q = torch.randn(1, 40, 2, d, device=dev).to(torch.bfloat16)
        before = _route_counts()
        fa.flash_fwd(q, q, q, True, d ** -0.5)
        assert _route_delta(before) == {f"fwd_cuda_{route}": 1}, d
    for name in sorted(_TRAIN_CASES):
        q, k, v, do, causal, window, se = _train_inputs(dev, name,
                                                        torch.bfloat16)
        before = _route_counts()
        out, lse = fa.flash_fwd(q, k, v, causal, 0.1, window, se,
                                want_lse=True)
        fa.flash_bwd(q, k, v, out, lse, do, causal, 0.1, window, se)
        assert _route_delta(before) == _TC_PASS, name


def _gate(got, ref, atol_floor=0.0):
    """chip_smoke.py's ``closeness`` rule, |got - ref| <= rtol |ref| +
    atol: for a 16-bit output rtol eps(dtype) and atol 1e-3 rms(ref), for
    an f32 one rtol 0 and atol 1e-4 max(1, max |ref|); ``atol_floor``
    raises atol to at least that value. Returns the worst ratio (pass:
    <= 1)."""
    half = got.dtype != torch.float32
    rtol = torch.finfo(got.dtype).eps if half else 0.0
    got, ref = got.float(), ref.float()
    atol = 1e-3 * float(ref.square().mean().sqrt()) if half else \
        1e-4 * max(1.0, float(ref.abs().max()))
    atol = max(atol, atol_floor, 1e-30)
    return float(((got - ref).abs() / (rtol * ref.abs() + atol)).max())


# (B, sq, sk, h, hkv, d, causal, window, mask) on the tensor-core route
_TC_CASES = {
    "d64": (2, 200, 200, 4, 4, 64, True, None, None),
    "d128": (2, 200, 200, 4, 4, 128, True, None, None),
    "d256": (1, 150, 150, 4, 2, 256, True, None, None),
    "d40_full": (2, 77, 77, 2, 2, 40, False, None, None),
    "empty_rows": (1, 100, 77, 4, 2, 128, True, None, None),
    "sk_ragged": (1, 64, 200, 4, 4, 128, True, None, None),
    "gqa4": (2, 160, 160, 8, 2, 128, True, None, None),
    "window": (1, 300, 300, 4, 2, 64, True, 40, None),
    "bands_c2": (2, 150, 150, 4, 2, 64, True, None, "c2"),
    "bands_c4": (1, 150, 150, 4, 4, 128, False, None, "c4"),
    "doc_mask": (2, 300, 300, 4, 2, 128, True, None, "doc"),
}


#: a pass's launches by route: bf16 on tc throughout; fp16's forward on
#: tc, its backward on simt (dS does not fit fp16 once split); f32's
#: forward on tf32x3, its backward on simt
_PASS_ROUTES = {
    torch.bfloat16: _TC_PASS,
    torch.float16: {"fwd_cuda_tc": 1, "dq_cuda_simt": 1,
                    "dkv_cuda_simt": 1},
    torch.float32: {"fwd_cuda_tf32x3": 1, "dq_cuda_simt": 1,
                    "dkv_cuda_simt": 1},
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("name", sorted(_TC_CASES))
def test_flash_tc_route_within_gate(dev, dtype, name):
    """The tensor-core forward (out, lse; tc for 16-bit operands, tf32x3
    for f32), dQ and dK/dV against the plain versions under
    chip_smoke.py's element-wise gate (f32: atol 1e-4 of max(1,
    max |ref|)), on the routes the counters name. Rows without keys give
    zeros, NEG_INF lse and zero dQ."""
    q, k, v, do, causal, window, se = _train_inputs(dev, name, dtype,
                                                    _TC_CASES)
    scale = q.shape[-1] ** -0.5
    t = lambda x: x.transpose(1, 2).float()              # noqa: E731
    before = _route_counts()
    out, lse = fa.flash_fwd(q, k, v, causal, scale, window, se,
                            want_lse=True)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_plain(t(q), t(k), t(v), causal, scale, window,
                                    se, return_lse=True)
    assert _gate(out, want.transpose(1, 2)) <= 1.0
    dead = want_lse <= fa.ROW_INVALID_LSE
    assert torch.equal(lse <= fa.ROW_INVALID_LSE, dead)
    _close(lse[~dead], want_lse[~dead], 1e-5)
    assert not out.transpose(1, 2)[dead].any()
    grads = fa.flash_bwd(q, k, v, out, lse, do, causal, scale, window, se)
    torch.cuda.synchronize()
    assert _route_delta(before) == _PASS_ROUTES[dtype]
    ref = fa.flash_bwd_plain(t(q), t(k), t(v), t(out), lse, t(do), causal,
                             scale, window, se)
    for g_, r_, n in zip(grads, ref, ("dq", "dk", "dv")):
        assert g_.dtype == dtype and g_.shape == r_.transpose(1, 2).shape
        assert _gate(g_, r_.transpose(1, 2)) <= 1.0, n
    assert not grads[0].transpose(1, 2)[dead].any()


#: fp16's smallest subnormal step: one rounding of an f32 result to fp16
#: can be off by half of it wherever |result| < 2^-14
F16_STEP = 2.0 ** -24


@pytest.mark.parametrize("mul", [1e-4, 1e-5, 1e4])
def test_flash_fp16_backward_on_simt_small_and_large_do(dev, mul):
    """fp16 dO scaled far from 1: the backward runs on simt (dS in f32, as
    the reference keeps it), so dQ, dK and dV are finite and within the
    fp16 gate, its atol floored at one fp16 subnormal step (at x 1e-4 and
    x 1e-5 the outputs lie below 2^-14, where one rounding to fp16 may
    cost that much), where the 16-bit split of dS would lose bits or
    overflow (tests/test_torch_flash_tc_arith.py)."""
    g = torch.Generator().manual_seed(int(-math.log10(mul)) + 20)
    B, S, H, D = 1, 256, 2, 128
    q, k, v = (torch.randn(B, S, H, D, generator=g).to(dev, torch.float16)
               for _ in range(3))
    do = (torch.randn(B, S, H, D, generator=g) * mul).to(dev, torch.float16)
    scale = D ** -0.5
    t = lambda x: x.transpose(1, 2).float()              # noqa: E731
    out, lse = fa.flash_fwd(q, k, v, True, scale, want_lse=True)
    before = _route_counts()
    grads = fa.flash_bwd(q, k, v, out, lse, do, True, scale)
    torch.cuda.synchronize()
    assert _route_delta(before) == {"dq_cuda_simt": 1, "dkv_cuda_simt": 1}
    ref = fa.flash_bwd_plain(t(q), t(k), t(v), t(out), lse, t(do), True,
                             scale)
    for g_, r_, n in zip(grads, ref, ("dq", "dk", "dv")):
        assert bool(torch.isfinite(r_.half()).all()), n
        assert bool(torch.isfinite(g_).all()), n
        assert _gate(g_, r_.transpose(1, 2), F16_STEP) <= 1.0, n


def test_flash_tf32x3_reads_strided_views(dev):
    """f32 q/k/v as views of one fused [B, S, 3, H, D] projection and dO
    as a head-major view stay on the tf32x3 forward (strides multiples of
    4) and give what their contiguous copies give, bit for bit; a view
    whose rows are not 16-byte aligned takes the simt forward and the same
    answer within the f32 gate."""
    g = torch.Generator().manual_seed(10)
    qkv = torch.randn(2, 130, 3, 4, 64, generator=g).to(dev)
    q, k, v = qkv.unbind(2)
    before = _route_counts()
    out, lse = fa.flash_fwd(q, k, v, True, 0.125, want_lse=True)
    assert _route_delta(before) == {"fwd_cuda_tf32x3": 1}
    out2, lse2 = fa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                              True, 0.125, want_lse=True)
    torch.testing.assert_close(out, out2, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse2, rtol=0, atol=0)
    wide = torch.randn(2, 130, 4, 72, generator=g).to(dev)
    q_odd = wide[..., 2:66]                      # rows 8 bytes off
    assert fa.flash_route("fwd", q_odd.dtype, 64, q_odd.stride()[:3],
                          [q_odd.data_ptr()]) == "simt"
    before = _route_counts()
    out3 = fa.flash_fwd(q_odd, k, v, True, 0.125)
    assert _route_delta(before) == {"fwd_cuda_simt": 1}
    want = fa.flash_plain(*(x.transpose(1, 2).float() for x in (q_odd, k, v)),
                          True, 0.125).transpose(1, 2)
    _close(out3, want, 1e-4)


def test_flash_tc_reads_strided_views(dev):
    """bf16 q/k/v as views of one fused [B, S, 3, H, D] projection and dO
    as a head-major view stay on the tc route (their strides are
    multiples of 8) and give what their contiguous copies give, bit for
    bit; a view whose rows are not 16-byte aligned takes the simt route
    and the same answer within the gate."""
    g = torch.Generator().manual_seed(9)
    qkv = torch.randn(2, 130, 3, 4, 64, generator=g).to(dev, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, 4, 130, 64, generator=g).to(
        dev, torch.bfloat16).transpose(1, 2)
    before = _route_counts()
    out, lse = fa.flash_fwd(q, k, v, True, 0.125, want_lse=True)
    grads = fa.flash_bwd(q, k, v, out, lse, do, True, 0.125)
    assert _route_delta(before) == _TC_PASS
    cont = [x.contiguous() for x in (q, k, v, do)]
    out2, lse2 = fa.flash_fwd(*cont[:3], True, 0.125, want_lse=True)
    grads2 = fa.flash_bwd(*cont[:3], out2, lse2, cont[3], True, 0.125)
    for a, b in zip((out, lse, *grads), (out2, lse2, *grads2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    wide = torch.randn(2, 130, 4, 72, generator=g).to(dev, torch.bfloat16)
    q_odd = wide[..., 1:65]                      # rows 2 bytes off
    assert fa.flash_route("fwd", q_odd.dtype, 64, q_odd.stride()[:3],
                          [q_odd.data_ptr()]) == "simt"
    before = _route_counts()
    out3 = fa.flash_fwd(q_odd, k, v, True, 0.125)
    assert _route_delta(before) == {"fwd_cuda_simt": 1}
    want = fa.flash_plain(*(x.transpose(1, 2).float() for x in (q_odd, k, v)),
                          True, 0.125).transpose(1, 2)
    assert _gate(out3, want) <= 1.0


def _wgmma_launches():
    from paddle_tpu_torch import monitor
    return monitor.counter("kernels.flash.fwd_cuda_tc_wgmma").get()


# (B, sq, sk, h, hkv, d, causal, window, mask): the tc forward's wgmma
# kernel (head dims up to 128)
_WGMMA_CASES = {
    "causal_d64": (2, 300, 300, 4, 4, 64, True, None, None),
    "causal_d128": (2, 300, 300, 4, 4, 128, True, None, None),
    "full_d64": (2, 200, 200, 4, 4, 64, False, None, None),
    "full_d128": (1, 260, 260, 4, 4, 128, False, None, None),
    "gqa4_d128": (2, 256, 256, 8, 2, 128, True, None, None),
    "gqa2_d64": (1, 256, 256, 4, 2, 64, True, None, None),
    "window_d64": (1, 400, 400, 4, 2, 64, True, 100, None),
    "window_d128": (1, 400, 400, 4, 2, 128, True, 100, None),
    "doc4_d64": (2, 512, 512, 4, 2, 64, True, None, "doc4"),
    "doc4_d128": (2, 512, 512, 4, 4, 128, True, None, "doc4"),
    "bands_c4_d128": (1, 150, 150, 4, 4, 128, False, None, "c4"),
    "sq333_sk1024_d64": (1, 333, 1024, 4, 2, 64, True, None, None),
    "sq333_sk1024_d128": (1, 333, 1024, 4, 4, 128, True, None, None),
    "no_key_rows_d128": (1, 200, 77, 4, 2, 128, True, None, None),
    "no_key_rows_d64": (1, 300, 130, 2, 2, 64, True, 30, None),
    "d40_full": (1, 77, 77, 2, 2, 40, False, None, None),
    "d80_causal": (1, 150, 150, 2, 1, 80, True, None, None),
    "d32_causal": (2, 129, 129, 2, 2, 32, True, None, None),
    "d96_causal": (1, 200, 200, 4, 2, 96, True, None, None),
    "d96_window_gqa": (2, 260, 260, 8, 2, 96, True, 70, None),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(_WGMMA_CASES))
def test_flash_fwd_wgmma_within_gate(dev, dtype, name):
    """The tc forward at head dims up to 128 launches the wgmma kernel
    (``kernels.flash.fwd_cuda_tc_wgmma``) and holds chip_smoke.py's gate
    against the plain version: causal and full, GQA, windows, a
    4-document flashmask and random C=4 bands (whole key tiles skipped),
    sq 333 / sk 1024, ragged head dims, rows that see no key (zeros and
    NEG_INF logsumexp); the logsumexp within 1e-5 of its largest value."""
    q, k, v, do, causal, window, se = _train_inputs(dev, name, dtype,
                                                    _WGMMA_CASES)
    d = q.shape[-1]
    assert fa.flash_fwd_tc_kernel(d) == "wgmma"
    t = lambda x: x.transpose(1, 2).float()              # noqa: E731
    before, n = _route_counts(), _wgmma_launches()
    out, lse = fa.flash_fwd(q, k, v, causal, d ** -0.5, window, se,
                            want_lse=True)
    torch.cuda.synchronize()
    assert _route_delta(before) == {"fwd_cuda_tc": 1}
    assert _wgmma_launches() == n + 1
    want, want_lse = fa.flash_plain(t(q), t(k), t(v), causal, d ** -0.5,
                                    window, se, return_lse=True)
    assert _gate(out, want.transpose(1, 2)) <= 1.0
    dead = want_lse <= fa.ROW_INVALID_LSE
    assert torch.equal(lse <= fa.ROW_INVALID_LSE, dead)
    assert bool((lse[dead] == fa.NEG_INF).all())
    _close(lse[~dead], want_lse[~dead], 1e-5)
    assert not out.transpose(1, 2)[dead].any()
    if name.startswith("no_key_rows"):
        assert bool(dead.any())
    # the same launch without logsumexp writes the same output
    out2 = fa.flash_fwd(q, k, v, causal, d ** -0.5, window, se)
    torch.testing.assert_close(out, out2, rtol=0, atol=0)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_wgmma_reads_strided_views(dev, d):
    """bf16 q/k/v as views of one fused [B, S, 3, H, D] projection, and k
    as a head-major [B, H, S, D] buffer read transposed (strides of any
    order, multiples of 8): the wgmma kernel's tensor maps take the views
    as they are and give what the contiguous copies give, bit for bit."""
    g = torch.Generator().manual_seed(d)
    qkv = torch.randn(2, 200, 3, 4, d, generator=g).to(dev, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    k_heads = torch.randn(2, 4, 200, d, generator=g).to(
        dev, torch.bfloat16).transpose(1, 2)
    for kk in (k, k_heads):
        n = _wgmma_launches()
        out, lse = fa.flash_fwd(q, kk, v, True, 0.1, want_lse=True)
        assert _wgmma_launches() == n + 1
        out2, lse2 = fa.flash_fwd(q.contiguous(), kk.contiguous(),
                                  v.contiguous(), True, 0.1, want_lse=True)
        torch.testing.assert_close(out, out2, rtol=0, atol=0)
        torch.testing.assert_close(lse, lse2, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_fwd_d192_stays_on_mma_sync(dev, dtype):
    """Head dim 192 (tile head dim 256) keeps the tc route's mma.sync
    kernel: counted on ``fwd_cuda_tc``, not on ``fwd_cuda_tc_wgmma``, and
    within the gate."""
    g = torch.Generator().manual_seed(192)
    q, k, v = (torch.randn(1, 150, 2, 192, generator=g).to(dev, dtype)
               for _ in range(3))
    assert fa.flash_fwd_tc_kernel(192) == "mma_sync"
    before, n = _route_counts(), _wgmma_launches()
    out = fa.flash_fwd(q, k, v, True, 192 ** -0.5)
    torch.cuda.synchronize()
    assert _route_delta(before) == {"fwd_cuda_tc": 1}
    assert _wgmma_launches() == n
    want = fa.flash_plain(*(x.transpose(1, 2).float() for x in (q, k, v)),
                          True, 192 ** -0.5).transpose(1, 2)
    assert _gate(out, want) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [32, 40, 60, 64, 80, 128, 136, 192, 256])
def test_flash_fwd_reports_the_kernel_of_the_rule(dev, dtype, d):
    """The kernel the forward's C entry reports it ran (the counters'
    source) is the one ``flash_route`` and ``flash_fwd_tc_kernel`` name,
    and its output is within the gate."""
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(1, 70, 2, d, generator=g).to(dev, dtype)
               for _ in range(3))
    out = torch.empty_like(q)
    launched = fa._fwd_launch(q, k, v, out, None, True, d ** -0.5, None,
                              None)
    route = fa._route_of("fwd", [q, k, v])
    assert launched == (route, fa.flash_fwd_tc_kernel(d)
                        if route == "tc" else None)
    want = fa.flash_plain(*(x.transpose(1, 2).float() for x in (q, k, v)),
                          True, d ** -0.5).transpose(1, 2)
    assert _gate(out, want) <= 1.0


def _bwd_wgmma_launches():
    from paddle_tpu_torch import monitor
    return {k: monitor.counter(f"kernels.flash.{k}_cuda_tc_wgmma").get()
            for k in ("dq", "dkv")}


@pytest.mark.parametrize("name", sorted(_WGMMA_CASES))
def test_flash_bwd_wgmma_within_gate(dev, name):
    """bf16 dQ and dK/dV at head dims up to 128 launch the wgmma kernels
    (``kernels.flash.{dq,dkv}_cuda_tc_wgmma``, from what the C entries
    report) and hold chip_smoke.py's gate against ``flash_bwd_plain``:
    causal and full, GQA, windows, a 4-document flashmask and random C=4
    bands (whole tiles skipped), sq 333 / sk 1024, rows that see no key
    (their dQ zero), head dims 32-128 and odd multiples of 8 (40, 80,
    96)."""
    q, k, v, do, causal, window, se = _train_inputs(dev, name,
                                                    torch.bfloat16,
                                                    _WGMMA_CASES)
    d = q.shape[-1]
    assert fa.flash_tc_kernel("dq", d) == "wgmma"
    scale = d ** -0.5
    t = lambda x: x.transpose(1, 2).float()              # noqa: E731
    out, lse = fa.flash_fwd(q, k, v, causal, scale, window, se,
                            want_lse=True)
    before, n = _route_counts(), _bwd_wgmma_launches()
    grads = fa.flash_bwd(q, k, v, out, lse, do, causal, scale, window, se)
    torch.cuda.synchronize()
    assert _route_delta(before) == {"dq_cuda_tc": 1, "dkv_cuda_tc": 1}
    assert _bwd_wgmma_launches() == {k_: v_ + 1 for k_, v_ in n.items()}
    ref = fa.flash_bwd_plain(t(q), t(k), t(v), t(out), lse, t(do), causal,
                             scale, window, se)
    for g_, r_, nm in zip(grads, ref, ("dq", "dk", "dv")):
        assert g_.dtype == torch.bfloat16
        assert g_.shape == r_.transpose(1, 2).shape, nm
        assert _gate(g_, r_.transpose(1, 2)) <= 1.0, nm
    dead = lse <= fa.ROW_INVALID_LSE
    assert not grads[0].transpose(1, 2)[dead].any()


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_wgmma_reads_strided_views(dev, d):
    """bf16 q/k/v as views of one fused [B, S, 3, H, D] projection and dO
    as a head-major view: the wgmma dQ and dK/dV kernels' tensor maps
    take them as they are and give what the contiguous copies give, bit
    for bit."""
    g = torch.Generator().manual_seed(d + 1)
    qkv = torch.randn(2, 190, 3, 4, d, generator=g).to(dev, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, 4, 190, d, generator=g).to(
        dev, torch.bfloat16).transpose(1, 2)
    out, lse = fa.flash_fwd(q, k, v, True, 0.1, want_lse=True)
    n = _bwd_wgmma_launches()
    grads = fa.flash_bwd(q, k, v, out, lse, do, True, 0.1)
    assert _bwd_wgmma_launches() == {k_: v_ + 1 for k_, v_ in n.items()}
    cont = [x.contiguous() for x in (q, k, v, do)]
    grads2 = fa.flash_bwd(*cont[:3], out, lse, cont[3], True, 0.1)
    for a, b in zip(grads, grads2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("d", [192, 256])
def test_flash_bwd_d192_d256_stay_on_mma_sync(dev, d):
    """Tile head dim 256 keeps the tc route's mma.sync dQ and dK/dV
    kernels: counted on ``dq_cuda_tc`` / ``dkv_cuda_tc``, not on the
    wgmma counters, and within the gate."""
    g = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn(1, 150, 2, d, generator=g).to(
        dev, torch.bfloat16) for _ in range(4))
    assert fa.flash_tc_kernel("dkv", d) == "mma_sync"
    out, lse = fa.flash_fwd(q, k, v, True, d ** -0.5, want_lse=True)
    before, n = _route_counts(), _bwd_wgmma_launches()
    grads = fa.flash_bwd(q, k, v, out, lse, do, True, d ** -0.5)
    torch.cuda.synchronize()
    assert _route_delta(before) == {"dq_cuda_tc": 1, "dkv_cuda_tc": 1}
    assert _bwd_wgmma_launches() == n
    t = lambda x: x.transpose(1, 2).float()              # noqa: E731
    ref = fa.flash_bwd_plain(t(q), t(k), t(v), t(out), lse, t(do), True,
                             d ** -0.5)
    for g_, r_ in zip(grads, ref):
        assert _gate(g_, r_.transpose(1, 2)) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [32, 40, 60, 64, 80, 96, 128, 136, 192, 256])
def test_flash_bwd_reports_the_kernel_of_the_rule(dev, dtype, d):
    """The kernel each backward C entry reports it ran (the counters'
    source) is the one ``flash_route`` and ``flash_tc_kernel`` name (bf16:
    wgmma up to 128, mma.sync above; fp16, f32 and head dim 60: simt), and
    its outputs are within the gate (fp16's atol floored at one fp16
    subnormal step, as the simt fp16 test does)."""
    g = torch.Generator().manual_seed(d + 7)
    q, k, v, do = (torch.randn(1, 70, 2, d, generator=g).to(dev, dtype)
                   for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, True, d ** -0.5, want_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    t = lambda x: x.transpose(1, 2).float()              # noqa: E731
    ref = fa.flash_bwd_plain(t(q), t(k), t(v), t(out), lse, t(do), True,
                             d ** -0.5)
    floor = F16_STEP if dtype == torch.float16 else 0.0
    for kernel, entry, outs in (("dq", "flash_bwd_dq_launch", (dq, None)),
                                ("dkv", "flash_bwd_dkv_launch", (dk, dv))):
        launched = fa._bwd_launch(entry, args, *outs, True, d ** -0.5, None,
                                  None)
        route = fa._route_of(kernel, [q, k, v, do])
        assert launched == (route, fa.flash_tc_kernel(kernel, d)
                            if route == "tc" else None), kernel
    torch.cuda.synchronize()
    for got, r_ in zip((dq, dk, dv), ref):
        assert _gate(got, r_.transpose(1, 2), floor) <= 1.0


def test_flash_dkv_wgmma_is_deterministic(dev):
    """dK and dV of a GQA case (4 query heads a kv head, a causal band and
    a document mask) on the wgmma kernel: each block sums its group in
    f32 in a fixed order and writes once, so two runs agree bit for bit."""
    q, k, v, do, causal, window, se = _train_inputs(dev, "doc4_d64",
                                                    torch.bfloat16,
                                                    _WGMMA_CASES)
    q = torch.cat([q, q.flip(2)], 2)          # 8 query heads over 2 kv
    do = torch.cat([do, do.flip(2)], 2)
    out, lse = fa.flash_fwd(q, k, v, causal, 0.125, window, se,
                            want_lse=True)
    n = _bwd_wgmma_launches()
    a = fa.flash_bwd(q, k, v, out, lse, do, causal, 0.125, window, se)
    b = fa.flash_bwd(q, k, v, out, lse, do, causal, 0.125, window, se)
    assert _bwd_wgmma_launches() == {k_: v_ + 2 for k_, v_ in n.items()}
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_bwd_reads_strided_grad(dev):
    """dO from autograd may be a non-contiguous view: same answer as its
    contiguous copy."""
    q, k, v, do, causal, window, se = _train_inputs(dev, "ragged",
                                                    torch.float32)
    out, lse = fa.flash_fwd(q, k, v, True, 0.1, want_lse=True)
    wide = torch.randn(2, 70, 4, 256, device=dev)
    do_view = wide[..., ::2]                    # last stride 2: copied
    do_heads = torch.randn(2, 4, 70, 128, device=dev).transpose(1, 2)
    for g in (do_view, do_heads):
        a = fa.flash_bwd(q, k, v, out, lse, g, True, 0.1)
        b = fa.flash_bwd(q, k, v, out, lse, g.contiguous(), True, 0.1)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_flash_autograd_on_cuda_launches_kernels(dev):
    """flash_attention with requires_grad runs the forward with lse and
    both backward kernels, and its grads match the CPU's plain path."""
    q, k, v, do, causal, window, se = _train_inputs(dev, "gqa_rep4",
                                                    torch.float32)
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    n = (fa.flash_fwd.launches, fa.flash_bwd.launches_dq,
         fa.flash_bwd.launches_dkv)
    fa.flash_attention(*ins, causal=True).backward(do)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches_dq,
            fa.flash_bwd.launches_dkv) == (n[0] + 1, n[1] + 1, n[2] + 1)
    cpu = [x.detach().cpu().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*cpu, causal=True).backward(do.cpu())
    for a, b in zip(ins, cpu):
        _close(a.grad.cpu(), b.grad, 1e-4)


# (E, C, h, dff, counts, activation)
_MOE_CASES = {
    "ragged_empty": (4, 70, 128, 256, [70, 0, 7, 64], "gelu"),
    "odd_geometry": (3, 37, 96, 200, [0, 37, 13], "relu"),
    "decode": (8, 8, 256, 384, [2, 3, 0, 1, 4, 2, 2, 2], "gelu"),
    "all_dead": (2, 16, 64, 64, [0, 0], "gelu"),
    # h and dff not multiples of 8: the tc route refuses every dtype
    "tc_refused": (3, 50, 100, 204, [50, 20, 0], "gelu"),
}


def _moe_inputs(dev, name, dtype):
    E, C, h, f, counts, act = _MOE_CASES[name]
    g = torch.Generator().manual_seed(len(name) * 11 + h)
    r = lambda *s, sc: (torch.randn(*s, generator=g) * sc).to(dev)  # noqa
    ops = [r(E, C, h, sc=0.5).to(dtype), r(E, h, f, sc=h ** -0.5).to(dtype),
           r(E, 1, f, sc=0.1), r(E, f, h, sc=f ** -0.5).to(dtype),
           r(E, 1, h, sc=0.1), torch.rand(E, C, 1, generator=g).to(dev)]
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
    return ops, cnt, r(E, C, h, sc=1.0).to(dtype), act


def _moe_route_counts():
    from paddle_tpu_torch import monitor
    return {f"{k}_{r}": monitor.counter(
        f"kernels.moe.grouped_ffn_{k}_cuda_{r}").get()
        for k in ("fwd", "dx", "dw") for r in ("tc", "rows", "simt")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(_MOE_CASES))
def test_grouped_ffn_kernels_match_plain(dev, dtype, name):
    """The forward, dx and dw kernels against the plain versions (f32 math
    from the same rounded inputs): dead rows of out, dx and dws zero; the
    forward, dx and dw launch on the route grouped_ffn_route names (bf16
    and fp16 with h and dff multiples of 8: tc)."""
    from paddle_tpu_torch.kernels import moe
    ops, cnt, g, act = _moe_inputs(dev, name, dtype)
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    n = (moe.grouped_ffn_fwd.launches, moe.grouped_ffn_bwd.launches_dx,
         moe.grouped_ffn_bwd.launches_dw)
    routes = _moe_route_counts()
    out = moe.grouped_ffn_fwd(*ops, cnt, act)
    grads = moe.grouped_ffn_bwd(*ops, cnt, g, act)
    torch.cuda.synchronize()
    assert (moe.grouped_ffn_fwd.launches, moe.grouped_ffn_bwd.launches_dx,
            moe.grouped_ffn_bwd.launches_dw) == (n[0] + 1, n[1] + 1,
                                                 n[2] + 1)
    E, C, h = ops[0].shape
    route = moe.grouped_ffn_route(dtype, h, ops[1].shape[2])
    assert route == ("simt" if dtype == torch.float32 or name == "tc_refused"
                     else "tc")
    fwd = moe.grouped_ffn_route(dtype, h, ops[1].shape[2], C)
    assert fwd == ("rows" if dtype == torch.float32
                   and C <= moe.ROWS_MAX_CAPACITY and name != "tc_refused"
                   else route)
    want = {k: v + (k == "fwd_" + fwd or k in ("dx_" + route, "dw_" + route))
            for k, v in routes.items()}
    assert _moe_route_counts() == want
    _close(out, moe.grouped_ffn_plain(*ops, cnt, act), rtol)
    ref = moe.grouped_ffn_bwd_plain(*ops, cnt, g, act)
    for a, b in zip(grads, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, rtol)
    dead = torch.arange(ops[0].shape[1], device=dev)[None] >= cnt[:, None]
    for t in (out, grads[0], grads[5]):
        assert not t[dead].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_grouped_ffn_tc_dead_rows_hold_nan(dev, dtype):
    """Live counts that end mid-way through a 128-row tile, NaN in the
    dead rows of x and g and in every scratch row before the launches:
    the tc kernels read those rows inside a live tile but drop them by a
    select, so live outputs are finite and equal the plain version's (on
    the same inputs with the dead rows zero), and the dead rows of out, dx
    and dws are exactly 0."""
    from paddle_tpu_torch.kernels import moe
    E, C, h, f, act = 3, 256, 128, 192, "gelu"
    cnt = torch.tensor([77, 150, 0], dtype=torch.int32, device=dev)
    assert moe.grouped_ffn_route(dtype, h, f) == "tc"
    g = torch.Generator().manual_seed(17)
    r = lambda *s, sc: (torch.randn(*s, generator=g) * sc).to(dev)  # noqa
    ops = [r(E, C, h, sc=0.5).to(dtype), r(E, h, f, sc=h ** -0.5).to(dtype),
           r(E, 1, f, sc=0.1), r(E, f, h, sc=f ** -0.5).to(dtype),
           r(E, 1, h, sc=0.1), torch.rand(E, C, 1, generator=g).to(dev)]
    gg = r(E, C, h, sc=1.0).to(dtype)
    dead = torch.arange(C, device=dev)[None] >= cnt[:, None]
    clean = [t.clone() for t in ops] + [gg.clone()]
    ops[0][dead] = float("nan")
    gg[dead] = float("nan")
    nan = lambda t: t.fill_(float("nan"))  # noqa: E731
    out = torch.empty_like(ops[0])
    moe._fwd_launch((*ops, cnt), nan(torch.empty(E, C, f, dtype=dtype,
                                                  device=dev)), out, act)
    s = moe._bwd_scratch(ops[0], f)
    for k in ("ha", "dz", "gw"):
        nan(s[k])
    dx = torch.empty_like(ops[0])
    dws = torch.empty(E, C, 1, device=dev)
    db2 = torch.empty(E, 1, h, device=dev)
    dw1, dw2 = torch.empty_like(ops[1]), torch.empty_like(ops[3])
    db1 = torch.empty(E, 1, f, device=dev)
    bops = (*ops, cnt, gg)
    moe._bwd_dx_launch(bops, s, dx, dws, db2, act)
    moe._bwd_dw_launch(bops, s, dw1, db1, dw2)
    torch.cuda.synchronize()
    fwd_ref = moe.grouped_ffn_plain(*clean[:6], cnt, act)
    ref = moe.grouped_ffn_bwd_plain(*clean[:6], cnt, clean[6], act)
    for got, want in zip((out, dx, dw1, db1, dw2, db2, dws),
                         (fwd_ref,) + ref):
        assert bool(torch.isfinite(got).all())
        _close(got, want, 1e-2)
    for t in (out, dx, dws):
        assert not t[dead].any()
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_grouped_ffn_dw_tc_counts_and_nan_dead_rows(dev, dtype):
    """The dw kernel on the tc route at live counts 0, 1, 63, 64, 65 and C
    (an empty expert, a last 64-row stage with one live row, a whole one,
    one past it, the capacity), with NaN in every dead row of x and of
    the scratch ha and dz: the dead rows of the last stage are zeroed
    before its products, so dw1 and dw2 are finite and hold the gate
    against the plain formula on the dx kernel's own intermediates (f32
    math, rounded once); an empty expert's dw1 and dw2 are exactly 0."""
    from paddle_tpu_torch.kernels import moe
    E, C, h, f, act = 6, 200, 128, 192, "gelu"
    cnt = torch.tensor([0, 1, 63, 64, 65, C], dtype=torch.int32, device=dev)
    assert moe.grouped_ffn_route(dtype, h, f) == "tc"
    g = torch.Generator().manual_seed(23)
    r = lambda *s, sc: (torch.randn(*s, generator=g) * sc).to(dev)  # noqa
    ops = [r(E, C, h, sc=0.5).to(dtype), r(E, h, f, sc=h ** -0.5).to(dtype),
           r(E, 1, f, sc=0.1), r(E, f, h, sc=f ** -0.5).to(dtype),
           r(E, 1, h, sc=0.1), torch.rand(E, C, 1, generator=g).to(dev)]
    gg = r(E, C, h, sc=1.0).to(dtype)
    keep = moe._row_mask(cnt, C, dev)
    x_clean = torch.where(keep, ops[0].float(), 0.0)
    ops[0] = torch.where(keep, ops[0], float("nan")).to(dtype)
    s = moe._bwd_scratch(ops[0], f)
    for k in ("ha", "dz", "gw"):
        s[k].fill_(float("nan"))
    bops = (*ops, cnt, gg)
    dx = torch.empty_like(ops[0])
    dws = torch.empty(E, C, 1, device=dev)
    db2 = torch.empty(E, 1, h, device=dev)
    moe._bwd_dx_launch(bops, s, dx, dws, db2, act)
    dead = ~keep[..., 0]
    assert bool(s["ha"][dead].isnan().all() and s["dz"][dead].isnan().all())
    dw1, dw2 = torch.empty_like(ops[1]), torch.empty_like(ops[3])
    db1 = torch.empty(E, 1, f, device=dev)
    moe._bwd_dw_launch(bops, s, dw1, db1, dw2)
    torch.cuda.synchronize()
    ha_k = torch.where(keep, s["ha"].float(), 0.0)
    dz_k = torch.where(keep, s["dz"].float(), 0.0)
    gw = moe.grouped_ffn_gw_plain(gg, ops[5], cnt).float()
    for got, want in ((dw1, torch.bmm(x_clean.transpose(1, 2), dz_k)),
                      (dw2, torch.bmm(ha_k.transpose(1, 2), gw))):
        assert bool(torch.isfinite(got).all())
        assert _gate(got, want) <= 1.0
        assert not got[0].any()
    ref = moe.grouped_ffn_bwd_plain(torch.where(keep, ops[0], 0.0), *ops[1:],
                                    cnt, gg, act)
    _close(db1, ref[2], 1e-4)


def _rows_inputs(dev, E, C, h, f, counts, seed, nan_dead=False):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc: (torch.randn(*s, generator=g) * sc).to(dev)  # noqa
    ops = [r(E, C, h, sc=0.5), r(E, h, f, sc=h ** -0.5), r(E, 1, f, sc=0.1),
           r(E, f, h, sc=f ** -0.5), r(E, 1, h, sc=0.1),
           torch.rand(E, C, 1, generator=g).to(dev)]
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
    dead = torch.arange(C, device=dev)[None] >= cnt[:, None]
    clean = [t.clone() for t in ops]
    if nan_dead:
        ops[0][dead] = float("nan")
    return ops, clean, cnt, dead


@pytest.mark.parametrize("name,E,C,h,f,counts", [
    ("decode", 8, 8, 1024, 2816, [2, 3, 0, 1, 4, 2, 2, 2]),
    ("odd_counts", 8, 8, 1024, 2816, [1, 3, 5, 7, 0, 8, 6, 1]),
    ("cap16", 4, 16, 512, 1408, [16, 9, 0, 15]),
    ("k_tail", 3, 9, 300, 520, [9, 0, 4]),
])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_grouped_ffn_rows_route(dev, name, E, C, h, f, counts, act):
    """The forward's "rows" route (f32, capacity <= ROWS_MAX_CAPACITY) at
    the serving decode shape and odd counts, an empty expert, capacities
    8 and 16 (both row templates) and K splits with a tail (h 300, dff
    520), NaN in every dead row of x: within the f32 gate of the plain
    version on the clean inputs, live rows finite, dead rows exactly 0,
    counted on the route the C entry reports."""
    from paddle_tpu_torch.kernels import moe
    ops, clean, cnt, dead = _rows_inputs(dev, E, C, h, f, counts,
                                         len(name) + C, nan_dead=True)
    assert moe.grouped_ffn_route(torch.float32, h, f, C) == "rows"
    routes, n = _moe_route_counts(), moe.grouped_ffn_fwd.launches
    out = moe.grouped_ffn_fwd(*ops, cnt, act)
    torch.cuda.synchronize()
    assert moe.grouped_ffn_fwd.launches == n + 1
    assert _moe_route_counts() == dict(routes,
                                       fwd_rows=routes["fwd_rows"] + 1)
    want = moe.grouped_ffn_plain(*clean, cnt, act)
    assert bool(torch.isfinite(out).all())
    assert _gate(out, want) <= 1.0
    assert not out[dead].any()


def test_grouped_ffn_rows_threshold_and_split_scratch(dev):
    """One row over the threshold takes the simt tiles; the rows route's
    scratch holds the down pass's K-split partials of the live rows,
    which sum (in split order, with b2 and ws) to its output."""
    from paddle_tpu_torch.kernels import moe
    E, h, f = 4, 256, 640
    C = moe.ROWS_MAX_CAPACITY + 1
    ops, _, cnt, _ = _rows_inputs(dev, E, C, h, f, [C, 3, 0, 9], 31)
    routes = _moe_route_counts()
    out = moe.grouped_ffn_fwd(*ops, cnt, "gelu")
    assert _moe_route_counts() == dict(routes,
                                       fwd_simt=routes["fwd_simt"] + 1)
    _close(out, moe.grouped_ffn_plain(*ops, cnt, "gelu"), 1e-4)
    C = moe.ROWS_MAX_CAPACITY
    ops, _, cnt, dead = _rows_inputs(dev, E, C, h, f, [C, 3, 0, 9], 32)
    part = moe.grouped_ffn_rows_scratch(E, C, h, f, dev)
    ha = torch.empty(E, C, f, device=dev)
    out = torch.empty(E, C, h, device=dev)
    assert moe._fwd_launch((*ops, cnt), ha, out, "gelu", part) == "rows"
    torch.cuda.synchronize()
    S = -(-f // moe.ROWS_K_SPLIT)
    parts = part[:S * E * C * h].reshape(S, E, C, h)
    total = parts[0]
    for k in range(1, S):
        total = total + parts[k]
    keep = ~dead[..., None]
    re = torch.where(keep, (total + ops[4]) * ops[5], 0.0)
    torch.testing.assert_close(out, re, rtol=0, atol=0)


def test_grouped_ffn_autograd_on_cuda_matches_cpu(dev):
    """grouped_ffn with requires_grad launches the forward and both
    backward kernels, and its grads match the CPU's plain path."""
    from paddle_tpu_torch.kernels import moe
    ops, cnt, g, act = _moe_inputs(dev, "ragged_empty", torch.float32)
    ins = [t.clone().requires_grad_() for t in ops]
    n = moe.grouped_ffn_bwd.launches_dw
    moe.grouped_ffn(*ins, cnt, activation=act).backward(g)
    torch.cuda.synchronize()
    assert moe.grouped_ffn_bwd.launches_dw == n + 1
    cpu = [t.detach().cpu().requires_grad_() for t in ops]
    moe.grouped_ffn(*cpu, cnt.cpu(), activation=act).backward(g.cpu())
    for a, b in zip(ins, cpu):
        _close(a.grad.cpu(), b.grad, 1e-4)


# -- the encoder slice: the head-dim-64 probe, key bands, dead rows ----------

def test_minor64_probe_matches_plain_and_caches(dev):
    """The probe launches once, equals (x x^T) x bit for bit on its
    small-integer tile, and marks the device: ``minor64_supported`` then
    launches nothing more."""
    n = fa.probe_minor64.launches
    out = fa.probe_minor64(dev)
    assert fa.probe_minor64.launches == n + 1
    assert torch.equal(out, fa.minor64_probe_plain(fa.minor64_input(dev)))
    assert fa.minor64_supported(dev)
    assert fa.probe_minor64.launches == n + 1


def _encoder_bands(dev, B, L, H, dead, seed):
    """C=1 key bands of a pinned batch's padding mask: the last ``dead``
    rows mask every key, one row keeps all L, the rest ragged."""
    from paddle_tpu_torch.nn.functional import _mask_to_key_bands
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, L, (B,), generator=g)
    lens[0] = L
    lens[B - dead:] = 0
    keep = (torch.arange(L)[None] < lens[:, None])[:, None, None].to(dev)
    se = fa._normalize_startend(_mask_to_key_bands(keep, B, L, L, H), L, L,
                                False)
    return keep, se


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [128, 96, 33])
def test_flash_encoder_key_bands_and_dead_rows(dev, dtype, L):
    """Head dim 64, non-causal, one band head broadcast over 6 q heads
    with a per-row batch stride: the forward with lse and both backward
    kernels against the plain versions; dead rows give zeros (and NEG_INF
    lse) and get zero gradients."""
    B, H, D, dead = 5, 6, 64, 2
    g = torch.Generator().manual_seed(L)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g).to(dev, dtype)
                   for _ in range(4))
    _, se = _encoder_bands(dev, B, L, H, dead, L)
    t = lambda x: x.transpose(1, 2).float()              # noqa: E731
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    out, lse = fa.flash_fwd(q, k, v, False, 0.125, None, se, want_lse=True)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_plain(t(q), t(k), t(v), False, 0.125, se=se,
                                    return_lse=True)
    _close(out, want.transpose(1, 2), rtol)
    assert not out[B - dead:].any()
    assert bool((lse[B - dead:] <= fa.ROW_INVALID_LSE).all())
    o = want.transpose(1, 2).to(dtype)
    got = fa.flash_bwd(q, k, v, o, want_lse, do, False, 0.125, None, se)
    ref = fa.flash_bwd_plain(t(q), t(k), t(v), t(o), want_lse, t(do), False,
                             0.125, None, se)
    for g_, r_ in zip(got, ref):
        _close(g_, r_.transpose(1, 2), rtol)
        assert not g_[B - dead:].any()


def test_sdpa_key_mask_on_cuda_matches_cpu(dev):
    """scaled_dot_product_attention with a padding mask takes the masked
    kernel route on the card, and its output and gradients match the
    CPU's plain route."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
    B, L, H, D = 4, 70, 4, 64
    keep, _ = _encoder_bands(dev, B, L, H, 1, 5)
    g = torch.Generator().manual_seed(6)
    base = [torch.randn(B, L, H, D, generator=g) for _ in range(3)]
    do = torch.randn(B, L, H, D, generator=g)
    counter = monitor.counter("kernels.flash.sdpa.kernel_mask")
    n = counter.get()
    ins = [x.to(dev).requires_grad_() for x in base]
    scaled_dot_product_attention(*ins, attn_mask=keep).backward(do.to(dev))
    assert counter.get() == n + 1
    cpu = [x.clone().requires_grad_() for x in base]
    out = scaled_dot_product_attention(*cpu, attn_mask=keep.cpu())
    out.backward(do)
    for a, b in zip(ins, cpu):
        _close(a.grad.cpu(), b.grad, 1e-4)


def test_batch_encoder_on_cuda_probes_and_matches_b1(dev, monkeypatch):
    """A head-dim-64 BERT in the BatchEncoder on the card: one probe
    launch at construction on a device not yet probed, none for a second
    encoder, batched embeddings equal to each request encoded alone
    (relative 1e-4, TF32 off)."""
    from paddle_tpu_torch.inference import BatchEncoder, EmbedParams
    from paddle_tpu_torch.text.models import BertConfig, BertModel
    cfg = BertConfig.tiny(vocab=64, hidden=128, layers=2, heads=2)
    net = BertModel(cfg, device=dev, seed=1)
    net.eval()
    monkeypatch.setattr(fa, "_minor64_ok", {})
    n = fa.probe_minor64.launches
    BatchEncoder(net, max_batch=4, bucket=16, max_seq=64)
    assert fa.probe_minor64.launches == n + 1
    svc = BatchEncoder(net, max_batch=4, bucket=16, max_seq=64)
    assert fa.probe_minor64.launches == n + 1
    g = torch.Generator().manual_seed(2)
    seqs = [torch.randint(1, 64, (int(s),), generator=g)
            for s in (5, 17, 33, 9, 40)]
    pools = ["cls", "mean", "mean", "cls", "mean"]
    outs = svc.run([(s, EmbedParams(pooling=p)) for s, p in zip(seqs, pools)])
    assert svc.steady_state_recompiles() == 0
    with torch.no_grad():
        for s, p, o in zip(seqs, pools, outs):
            x, pooled = net(s[None].to(dev))
            ref = (pooled[0] if p == "cls" else x[0].mean(0)).cpu()
            err = float((torch.from_numpy(o.embedding) - ref).abs().max())
            assert err <= 1e-4 * float(ref.abs().max()), err


# -- multi-tick decode on a CUDA graph ---------------------------------------

def _decoding_engine(dev, moe=False, k=8):
    """A tiny LLaMA (or ERNIE-MoE) Engine on the card with 4 greedy
    requests prefilled and decoding (one step: admit + prefill)."""
    from paddle_tpu_torch.inference import Engine, SamplingParams
    from paddle_tpu_torch.text import models
    if moe:
        cfg = models.ErnieMoEConfig.tiny(vocab=128, hidden=64, layers=2,
                                         heads=4, experts=4)
        model = models.ErnieMoEForCausalLM(cfg, device=dev, seed=0,
                                           init_std=0.2)
    else:
        cfg = models.LlamaConfig.tiny(vocab=128, hidden=64, layers=2,
                                      heads=4)
        model = models.LlamaForCausalLM(cfg, device=dev, seed=0,
                                        init_std=0.2)
    model.eval()
    eng = Engine(model, max_slots=4, page_size=16, max_context=128,
                 cache_dtype="float32", multi_tick=k)
    g = torch.Generator().manual_seed(5)
    for n in (5, 17, 30, 12):
        eng.add_request(torch.randint(0, 128, (n,), generator=g),
                        SamplingParams(max_new_tokens=40))
    eng.step()
    assert eng.num_active == 4
    return eng


def _load_multi(eng):
    import numpy as np
    bud = np.array([40 - len(r.generated) for r in eng._slots])
    eng._flush_bt()
    eng._multi.load(eng._last, eng._pos, eng._live,
                    np.full((4,), -1), bud)


@pytest.mark.parametrize("moe", [False, True], ids=["llama", "ernie_moe"])
def test_multi_tick_graph_replay_equals_eager_ticks(dev, moe):
    """The captured k=8 graph's replay writes the same tokens, ok flags,
    advanced state and pool pages as the eager body on the same inputs,
    bit for bit; the replay credits the wrappers' launch counts (8 ticks
    x 2 layers of paged decode, and the MoE layer's grouped-FFN forward)
    and the capture counted none of its own."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.kernels import moe as moe_kernels
    eng = _decoding_engine(dev, moe)
    mt = eng._multi
    pools0 = [t.clone() for c in eng._pools for t in c]
    _load_multi(eng)
    toks, oks = (t.clone() for t in mt.ticks(8))
    state = [t.clone() for t in (mt.last, mt.pos, mt.bud)]
    pools1 = [t.clone() for c in eng._pools for t in c]
    for dst, src in zip((t for c in eng._pools for t in c), pools0):
        dst.copy_(src)
    _load_multi(eng)
    mt.run(8)                                   # warm-up, capture, replay
    assert mt.captured == [8]
    _load_multi(eng)
    for dst, src in zip((t for c in eng._pools for t in c), pools0):
        dst.copy_(src)
    n_pd = pa.paged_decode.launches
    n_mon = monitor.counter("kernels.decode.paged_cuda").get()
    n_ffn = moe_kernels.grouped_ffn_fwd.launches
    gt, go = mt.run(8)                          # a replay only
    torch.cuda.synchronize()
    assert torch.equal(gt, toks) and torch.equal(go, oks)
    assert bool(oks.all())
    for got, want in zip((mt.last, mt.pos, mt.bud), state):
        assert torch.equal(got, want)
    for got, want in zip((t for c in eng._pools for t in c), pools1):
        assert torch.equal(got[1:], want[1:])   # page 0: the scratch page
    assert pa.paged_decode.launches - n_pd == 8 * 2
    assert monitor.counter("kernels.decode.paged_cuda").get() - n_mon == 16
    assert moe_kernels.grouped_ffn_fwd.launches - n_ffn == (8 if moe else 0)


@pytest.mark.parametrize("moe", [False, True], ids=["llama", "ernie_moe"])
def test_multi_tick_engine_tokens_equal_single_tick(dev, moe):
    """multi_tick=8 emits the single-tick engine's tokens bit for bit on
    the card, every fused dispatch a graph replay; paged-decode launches
    == device ticks x layers (the warm-up tick of each captured bucket
    counted among the ticks)."""
    outs = {}
    for k in (1, 8):
        eng = _decoding_engine(dev, moe, k=k)
        n_pd, t0 = pa.paged_decode.launches, eng.decode_ticks
        got = []
        while eng.num_active:
            got.extend(eng.step())
        assert pa.paged_decode.launches - n_pd == \
            (eng.decode_ticks - t0) * 2
        outs[k] = sorted((o.req_id, o.token_ids) for o in got)
        if k == 8:
            assert eng._multi.captured
        assert eng.leaked_pages() == 0
    assert outs[8] == outs[1]


def test_multi_tick_capture_raises_on_a_host_sync(dev, monkeypatch):
    """The capture runs under set_sync_debug_mode("error"): a body that
    syncs with the host (here an .item() in the forward) fails the
    capture loudly, naming it, and no graph is kept."""
    eng = _decoding_engine(dev)
    fwd = eng.model.forward

    def syncing(*a, **kw):
        out = fwd(*a, **kw)
        out[0].sum().item()
        return out

    monkeypatch.setattr(eng.model, "forward", syncing)
    _load_multi(eng)
    with pytest.raises(RuntimeError, match="multi-tick decode"):
        eng._multi.run(8)
    assert eng._multi.captured == []
    assert torch.cuda.get_sync_debug_mode() == 0


def _dead_engine(dev):
    """A k=8 Engine that captured its graph, dropped: an Engine is a
    reference cycle, so its graphs and pool pages wait for a collection.
    Returns a weak reference to its MultiTick (alive until collected)."""
    import weakref
    eng = _decoding_engine(dev)
    while eng.num_active:
        eng.step()
    assert eng._multi.captured
    ref = weakref.ref(eng._multi)
    del eng
    return ref


_COLLECT_IN_CAPTURE = """
import gc, sys, torch
sys.path.insert(0, "tests")
from test_torch_kernels_cuda import _dead_engine, _decoding_engine, _load_multi
from paddle_tpu_torch.inference import decode_graph
gc.collect()
gc.disable()
dev = torch.device("cuda")
ref = _dead_engine(dev)
assert ref() is not None
eng = _decoding_engine(dev)
ticks = decode_graph.MultiTick.ticks

def collecting(self, k, *a):
    if torch.cuda.is_current_stream_capturing():
        gc.collect()
    return ticks(self, k, *a)

decode_graph.MultiTick.ticks = collecting
_load_multi(eng)
try:
    eng._multi.run(8)
except RuntimeError as e:
    assert ref() is None
    print("FAILED:", str(e).splitlines()[0])
"""


def test_multi_tick_capture_fails_if_a_dead_engine_is_collected_in_it(dev):
    """Why the capture pauses the collector: a collection inside a
    capture that frees a dead Engine's graphs and memory invalidates the
    capture (forced here with an explicit gc.collect in the body). A
    failed capture leaves the CUDA generator's capture state behind, so
    this runs in a process of its own."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _COLLECT_IN_CAPTURE],
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "FAILED: multi-tick decode: the capture of the k=8" in run.stdout
    assert "during capture" in run.stdout


def test_multi_tick_capture_runs_no_collection(dev):
    """With a dead k=8 Engine pending and the collector at threshold 1,
    a new Engine captures its graph with no collection inside the
    capture, and its tokens equal those of the engine before it."""
    import gc
    seen = []

    def on_gc(phase, info):
        if phase == "start":
            seen.append(torch.cuda.is_current_stream_capturing())

    gc.collect()
    ref = _dead_engine(dev)
    threshold = gc.get_threshold()
    gc.callbacks.append(on_gc)
    gc.set_threshold(1, 1, 1)
    try:
        eng = _decoding_engine(dev)
        got = []
        while eng.num_active:
            got.extend(eng.step())
    finally:
        gc.set_threshold(*threshold)
        gc.callbacks.remove(on_gc)
    assert eng._multi.captured and seen and not any(seen)
    assert gc.isenabled()
    assert all(o.ok and len(o.token_ids) == 40 for o in got)
    del ref


# -- the reliability plane on the card ---------------------------------------

@pytest.mark.parametrize("k", [1, 8])
def test_decode_nan_fails_one_slot_on_card(dev, k):
    """A FaultPlan NaN in one slot's decode logits (the poisoned tick is
    a single-tick dispatch even under multi_tick) fails that slot alone,
    with the tokens it had; every other slot's tokens equal the
    fault-free run's, and no page leaks."""
    from paddle_tpu_torch.inference import FaultInjector, FaultPlan
    outs = {}
    for plan in (None, FaultPlan([(4, "decode.nan")])):
        eng = _decoding_engine(dev, k=k)
        if plan is not None:
            eng._injector = FaultInjector(plan=plan)
        got = []
        while eng.num_active:
            got.extend(eng.step())
        outs[plan is None] = {o.req_id: o for o in got}
        assert eng.leaked_pages() == 0
    clean, faulty = outs[True], outs[False]
    failed = [r for r, o in faulty.items() if not o.ok]
    assert len(failed) == 1 and faulty[failed[0]].error == "nan_logits"
    r = failed[0]
    assert faulty[r].token_ids == \
        clean[r].token_ids[:len(faulty[r].token_ids)]
    for rid, o in faulty.items():
        if rid != r:
            assert o.token_ids == clean[rid].token_ids, rid


def test_deadline_under_inflight_graph_hands_pages_to_new_request(dev):
    """A deadline that expires while a k=8 graph is in flight frees the
    request's pages in the step's overlap window; a request arriving in
    that window (admitted and prefilled in the same step) gets those
    pages, and its tokens — and the surviving request's — equal a run
    without the deadline: the prefill's writes follow the replay on the
    one stream. (7 pages hold the victim's and the survivor's lifetimes,
    so neither run preempts; the late request waits for a slot in the
    run without the deadline.)"""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.inference import Engine, SamplingParams
    from paddle_tpu_torch.text import models
    cfg = models.LlamaConfig.tiny(vocab=128, hidden=64, layers=2, heads=4)
    model = models.LlamaForCausalLM(cfg, device=dev, seed=0, init_std=0.2)
    model.eval()
    g = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, 128, (n,), generator=g) for n in (17, 5, 20)]
    res = {}
    for deadline in (None, 100.0):
        clk = {"t": 0.0}
        eng = Engine(model, max_slots=2, page_size=16, max_context=128,
                     pool_pages=7, cache_dtype="float32", multi_tick=8,
                     clock=lambda: clk["t"])
        victim = eng.add_request(prompts[0], SamplingParams(
            max_new_tokens=40, deadline_ms=deadline))
        eng.add_request(prompts[1], SamplingParams(max_new_tokens=40))
        for _ in range(3):
            eng.step()                    # prefill, then fused dispatches
        while eng.pages_free:             # until the pool is dry
            eng.step()
        pages = set(eng.requests[victim].pages)
        expire = eng._expire
        arrived = []

        def expire_then_arrive():
            outs = expire()
            arrived.append(eng.add_request(prompts[2], SamplingParams(
                max_new_tokens=24)))
            return outs

        eng._expire = expire_then_arrive
        clk["t"] = 1.0                    # past the victim's deadline
        d0 = monitor.counter("serving.multi_tick.dispatches").get()
        done = {o.req_id: o for o in eng.step()}
        eng._expire = expire
        assert monitor.counter("serving.multi_tick.dispatches").get() == \
            d0 + 1                        # the step's dispatch was fused
        if deadline is not None:
            assert done[victim].finish_reason == "deadline"
            new = eng.requests[arrived[0]]
            assert new.written and pages & set(new.pages), \
                (pages, new.pages)
        while eng.num_active or eng.num_waiting:
            done.update({o.req_id: o for o in eng.step()})
        assert eng.leaked_pages() == 0
        res[deadline] = done
    assert res[None][victim].ok and res[None][victim].preemptions == 0
    for rid, o in res[100.0].items():
        if rid != victim:
            assert o.ok and o.preemptions == 0
            assert o.token_ids == res[None][rid].token_ids, rid


# -- the fused Adam / AdamW update (csrc/fused_adam.cu) ----------------------

def _adam_case(dev, mdt, amsgrad, offset, seed):
    """Parameters of odd sizes (vector tails, a tensor of one element, one
    of several chunks), each ``offset`` elements into its buffer (1: not
    16-byte aligned, the scalar path), with state after three steps."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ps, gs, sts = [], [], []
    for n in (1, 7, 8, 4099, 8192 + 13, 3 * 8192):
        ps.append(torch.randn(n + offset, generator=g, device=dev)[offset:])
        gs.append(torch.randn(n, generator=g, device=dev) * 0.1)
        gs[-1][::5] = 0.0
        st = {"moment1": (torch.randn(n, generator=g, device=dev)
                          * 0.01).to(mdt),
              "moment2": (torch.rand(n, generator=g, device=dev)
                          * 1e-3).to(mdt),
              "beta1_pow": torch.tensor(0.9 ** 3, device=dev),
              "beta2_pow": torch.tensor(0.999 ** 3, device=dev)}
        if amsgrad:
            st["moment2_max"] = (torch.rand(n, generator=g, device=dev)
                                 * 1e-3).to(mdt)
        sts.append(st)
    return ps, gs, sts


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("decay", ["none", "decoupled", "l2"])
@pytest.mark.parametrize("amsgrad", [False, True])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
def test_fused_adam_bit_equal_to_plain(dev, mdt, amsgrad, decay, offset):
    """Three launches against three plain updates: every parameter and
    state slot equal bit for bit."""
    from paddle_tpu_torch.kernels import fused_adam as fad
    ps, gs, sts = _adam_case(dev, mdt, amsgrad, offset, seed=offset + 7)
    ref_p = [p.clone() for p in ps]
    ref_s = [{k: v.clone() for k, v in s.items()} for s in sts]
    lr = torch.tensor(3e-4, dtype=torch.float32, device=dev)
    launches = fad.fused_adam_launch.launches
    for _ in range(3):
        fad.fused_adam_launch(ps, gs, sts, 3e-4, 0.9, 0.999, 1e-8,
                              amsgrad=amsgrad, decay=decay, coeff=0.05)
        for p, g, s in zip(ref_p, gs, ref_s):
            fad.adam_update_plain(p, g, s, lr, 0.9, 0.999, 1e-8, amsgrad,
                                  decay, 0.05)
    torch.cuda.synchronize()
    assert fad.fused_adam_launch.launches == launches + 3
    for p, r in zip(ps, ref_p):
        assert torch.equal(p, r)
    for s, r in zip(sts, ref_s):
        for k in s:
            assert s[k].dtype == r[k].dtype and torch.equal(s[k], r[k]), k


def test_fused_adam_route_rule_matches_c(dev):
    from paddle_tpu_torch.kernels import fused_adam as fad
    lib = _build.load("fused_adam")
    dts = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}
    for a, pa_ in dts.items():
        for b, ga in dts.items():
            for c, ma in dts.items():
                want = fad.adam_update_route(dev, pa_, ga, ma) == "fused"
                assert bool(lib.fused_adam_route(a, b, c)) == want


def test_fused_adam_rejects_a_table_without_one_chunk(dev):
    from paddle_tpu_torch.kernels import fused_adam as fad
    ps, gs, sts = _adam_case(dev, torch.bfloat16, False, 0, seed=3)
    ref = [p.clone() for p in ps]
    tables = fad.adam_tables(ps, gs, sts, False)
    fad.fused_adam_launch(ps, gs, sts, 3e-4, 0.9, 0.999, 1e-8,
                          amsgrad=False,
                          tables=tables._replace(chunks=tables.chunks[:-1]))
    torch.cuda.synchronize()
    last = ps[-1][-8192:]
    assert torch.equal(last, ref[-1][-8192:])     # the dropped chunk
    assert not torch.equal(ps[-1][:8192], ref[-1][:8192])


def test_fused_adam_checks_every_launch(dev):
    """A launch after a good one, on the same addresses, where one
    parameter's moments are now bf16 views of the f32 buffers the first
    launch read: the check runs again and refuses the mixed dtypes."""
    from paddle_tpu_torch.kernels import fused_adam as fad
    ps, gs, sts = _adam_case(dev, torch.float32, False, 0, seed=5)
    fad.fused_adam_launch(ps, gs, sts, 3e-4, 0.9, 0.999, 1e-8,
                          amsgrad=False)
    n = ps[1].numel()
    for slot in ("moment1", "moment2"):
        view = sts[1][slot].view(torch.bfloat16)[:n]
        assert view.data_ptr() == sts[1][slot].data_ptr()
        sts[1][slot] = view
    launches = fad.fused_adam_launch.launches
    with pytest.raises(ValueError, match="one moment dtype"):
        fad.fused_adam_launch(ps, gs, sts, 3e-4, 0.9, 0.999, 1e-8,
                              amsgrad=False)
    assert fad.fused_adam_launch.launches == launches


def test_adam_routes_and_counters_on_card(dev):
    """An eager AdamW step: the f32 parameters in one fused launch, a bf16
    parameter under multi_precision on the plain route; the f32 result
    equal to the plain rule's bit for bit."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch import optimizer as topt
    g = torch.Generator(device=dev).manual_seed(0)
    f32 = [torch.nn.Parameter(torch.randn(n, generator=g, device=dev))
           for n in (33, 8200)]
    half = torch.nn.Parameter(torch.randn(64, generator=g, device=dev)
                              .to(torch.bfloat16))
    ref = [p.detach().clone() for p in f32]
    for p in f32 + [half]:
        p.grad = torch.randn(p.shape, generator=g, device=dev).to(p.dtype)
    monitor.reset()
    opt = topt.AdamW(1e-3, parameters=f32 + [half], multi_precision=True,
                     moment_dtype="bfloat16")
    opt.step()
    torch.cuda.synchronize()
    snap = monitor.snapshot()
    assert snap.get("kernels.optimizer.adam_fused") == 1
    assert snap.get("kernels.optimizer.adam_plain") == 1
    rule = topt.AdamW(1e-3, parameters=ref, moment_dtype="bfloat16")
    lr = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    for r, p in zip(ref, f32):
        rule._update(r, p.grad, rule._init_state(r), lr)
        assert torch.equal(p.detach(), r)
    assert opt._accumulators[id(half)]["_master_weight"].dtype == \
        torch.float32


# -- one-shot decoding -------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_generate_paged_on_card_matches_cpu(dev, cache_dtype):
    """generate(cache_impl="paged") on the card: every decode step on the
    CUDA split kernel (no plain call), and its greedy tokens held to the
    same weights on the CPU, teacher-forced: the card's tokens agree with
    the CPU no-cache argmax at >= 0.97 (f32 pool) / 0.85 (bf16 pool), the
    thresholds of chip_smoke.py."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.text import generate, models
    cfg = models.LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=4)
    cfg.num_key_value_heads = 2
    card = models.LlamaForCausalLM(cfg, device=dev, seed=0, init_std=0.2)
    cpu = models.LlamaForCausalLM(cfg, device="cpu", seed=0, init_std=0.2)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = torch.randint(0, 128, (4, 70), generator=torch.Generator()
                        .manual_seed(3))
    monitor.reset()
    launches = pa.paged_decode.launches
    out = generate(card, ids, 24, cache_impl="paged", page_size=16,
                   cache_dtype=cache_dtype)
    torch.cuda.synchronize()
    snap = monitor.snapshot()
    assert out.device.type == "cuda" and tuple(out.shape) == (4, 94)
    assert pa.paged_decode.launches - launches == 23 * 2
    assert snap.get("kernels.decode.paged_cuda_split") == 23 * 2
    assert not snap.get("kernels.decode.paged_plain")
    with torch.no_grad():
        want = cpu(out[:, :-1].cpu()).argmax(-1)[:, 69:]
    agree = float((out[:, 70:].cpu() == want).float().mean())
    assert agree >= (0.97 if cache_dtype == "float32" else 0.85), agree


# -- the eager dygraph surface (paddle_tpu_torch as paddle) ---------------------

def test_eager_surface_trains_on_the_kernels(dev):
    """The slice's path at a small size on the card: Embedding ->
    TransformerEncoder (bool key-padding mask) -> Linear -> cross_entropy
    under amp.auto_cast O1 bf16, AdamW, 3 steps. Every layer's attention
    takes the tc wgmma forward, dQ and dK/dV with key-mask bands, every
    step one fused Adam launch, and nothing runs a plain version."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import monitor, nn
    from paddle_tpu_torch.core import place as place_mod
    from paddle_tpu_torch.kernels import fused_adam as fad
    place_mod.set_device("gpu")
    paddle.seed(0)
    layers, steps = 2, 3
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        128, 2, 256, dropout=0.1, activation="gelu"), layers)
    emb, head = nn.Embedding(100, 128), nn.Linear(128, 2)
    opt = paddle.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01,
        parameters=emb.parameters() + enc.parameters() + head.parameters())
    g = torch.Generator().manual_seed(1)
    ids = paddle.to_tensor(torch.randint(0, 100, (4, 128), generator=g))
    lens = torch.tensor([128, 100, 64, 77])
    keep = paddle.to_tensor((torch.arange(128)[None] < lens[:, None])[
        :, None, None, :])
    labels = paddle.to_tensor(torch.randint(0, 2, (4,), generator=g))
    monitor.reset()
    fad.fused_adam_launch.launches = 0
    losses = []
    for _ in range(steps):
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            h = enc(emb(ids), src_mask=keep)
            loss = nn.functional.cross_entropy(head(h[:, 0]), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    snap = monitor.snapshot()
    want = layers * steps
    for k in ("fwd", "dq", "dkv"):
        assert snap.get(f"kernels.flash.{k}_cuda_tc_wgmma") == want, snap
    assert snap.get("kernels.flash.sdpa.kernel_mask") == want
    for k in ("plain", "plain_mask", "dense_mask", "core"):
        assert not snap.get(f"kernels.flash.sdpa.{k}"), snap
    assert snap.get("kernels.optimizer.adam_fused") == steps
    assert not snap.get("kernels.optimizer.adam_plain")
    assert fad.fused_adam_launch.launches >= steps
    assert all(math.isfinite(v) for v in losses)


@pytest.mark.parametrize("dtype,d,causal", [(torch.float32, 64, False),
                                            (torch.float32, 128, True),
                                            (torch.bfloat16, 64, True),
                                            (torch.bfloat16, 128, False)])
def test_flash_custom_op_bit_equal_to_the_direct_entry(dev, dtype, d,
                                                      causal):
    """``torch.ops.paddle_tpu_torch.flash_fwd`` (the op ``jit.save``
    exports) launches the same kernel as ``flash_fwd`` and counts it."""
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (torch.randn(2, 256, 4, d, generator=g, device=dev)
               .to(dtype) for _ in range(3))
    want = fa.flash_fwd(q, k, v, causal, d ** -0.5)
    n = fa.flash_fwd.launches
    got = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, None, causal,
                                               d ** -0.5, None)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == n + 1
    assert torch.equal(got, want)


def test_exported_bert_on_card_equals_eager(dev, tmp_path):
    """An f32 BertModel (head dim 64, 2 layers) through jit.save /
    jit.load on the card: the tf32x3 forward inside the exported program,
    once a layer, and the outputs within 1e-4 of the eager forward's
    scale."""
    from paddle_tpu_torch import jit, monitor
    from paddle_tpu_torch.text.models import BertConfig, BertModel
    cfg = BertConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256,
                     max_position_embeddings=128)
    model = BertModel(cfg, seed=0).eval()
    prefix = str(tmp_path / "bert")
    jit.save(model, prefix, input_spec=[jit.InputSpec([4, 64], "int64")])
    loaded = jit.load(prefix)
    ids = torch.randint(0, 512, (4, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        want = model(ids)
    loaded(ids)                                    # the first run loads
    monitor.reset()
    got = loaded(ids)
    torch.cuda.synchronize()
    assert monitor.snapshot().get("kernels.flash.fwd_cuda_tf32x3") == 2
    assert not monitor.snapshot().get("kernels.flash.fwd_plain")
    for g_, w in zip(got, want):
        _close(g_._data, w, 1e-4)


def test_hapi_fit_on_card_runs_the_kernels(dev):
    """paddle.Model on a 2-layer surface Transformer classifier, O1 -> a
    bf16 TrainStep: the wgmma forward, dQ and dK/dV once a layer and step,
    one fused Adam a step, the f32 evaluate on the tf32x3 forward."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import monitor, nn
    from paddle_tpu_torch.core import place as place_mod
    place_mod.set_device("gpu")
    paddle.seed(0)
    layers, steps = 2, 3
    net = nn.Sequential(nn.Embedding(100, 128), nn.TransformerEncoder(
        nn.TransformerEncoderLayer(128, 2, 256, dropout=0.1,
                                   activation="gelu"), layers))

    class Head(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(128, 2)

        def forward(self, h):
            return self.fc(h[:, 0])
    net.add_sublayer("head", Head())
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 100, (12, 128), generator=g)
    labels = torch.randint(0, 2, (12,), generator=g)
    ds = paddle.io.TensorDataset([paddle.to_tensor(ids, place="cpu"),
                                  paddle.to_tensor(labels, place="cpu")])
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.AdamW(1e-3, parameters=net.parameters()),
                  nn.CrossEntropyLoss(), paddle.metric.Accuracy(),
                  amp_configs={"level": "O1"})
    assert model._train_step is not None
    monitor.reset()
    model.fit(ds, batch_size=4, epochs=1, shuffle=False, verbose=0,
              num_workers=2)
    snap = monitor.snapshot()
    for k in ("fwd", "dq", "dkv"):
        assert snap.get(f"kernels.flash.{k}_cuda_tc_wgmma") == \
            layers * steps, snap
    assert snap.get("kernels.optimizer.adam_fused") == steps
    monitor.reset()
    logs = model.evaluate(ds, batch_size=4, verbose=0)
    snap = monitor.snapshot()
    assert snap.get("kernels.flash.fwd_cuda_tf32x3", 0) + snap.get(
        "kernels.flash.fwd_cuda_simt", 0) == layers * steps, snap
    assert math.isfinite(logs["loss"])


# -- weight-only quantized serving (quantization, nn.quant) ------------------

@pytest.mark.parametrize("t,k,n", [(1, 64, 40), (8, 64, 40), (17, 24, 16),
                                   (33, 20, 12), (128, 256, 96)])
def test_int_mm_route_pads_and_equals_the_cpu(dev, t, k, n):
    """torch._int_mm wants more than 16 rows and K, N multiples of 8: the
    wrapper pads with zeros and slices back; the int32 result equals the
    CPU route's exactly, and so does llm_int8_linear's at threshold 0."""
    from paddle_tpu_torch.nn import quant
    g = torch.Generator().manual_seed(t * 7 + k)
    a = torch.randint(-127, 128, (t, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    got = quant.int8_matmul(a.to(dev), b.to(dev))
    assert got.dtype == torch.int32 and tuple(got.shape) == (t, n)
    assert torch.equal(got.cpu(), quant.int8_matmul(a, b))
    x = torch.randn(t, k, generator=g)
    s = torch.rand(n, generator=g) * 0.01 + 1e-3
    want = quant.llm_int8_linear(x, b, None, s, threshold=0.0)
    card = quant.llm_int8_linear(x.to(dev), b.to(dev), None, s.to(dev),
                                 threshold=0.0)
    assert torch.equal(card.cpu(), want)


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
@pytest.mark.parametrize("k", [1, 8])
def test_quantized_engine_on_card_matches_cpu(dev, weight_dtype, k):
    """A converted tiny LLaMA served on the card (multi_tick 1 and 8, the
    decode ticks as CUDA graphs at 8) against the same converted weights
    on the CPU: every decode call on the split kernel, no plain call, and
    the greedy tokens teacher-forced against the CPU's no-cache argmax at
    >= 0.97 (f32 pool)."""
    import numpy as np
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.inference import Engine, SamplingParams
    from paddle_tpu_torch.quantization import (WeightOnlyLinear,
                                               quantize_for_inference)
    from paddle_tpu_torch.text import models
    cfg = models.LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=4)
    cpu = models.LlamaForCausalLM(cfg, device="cpu", seed=0, init_std=0.2)
    quantize_for_inference(cpu, weight_dtype)
    card = models.LlamaForCausalLM(cfg, device=dev, seed=0, init_std=0.2)
    quantize_for_inference(card, weight_dtype)
    card.load_state_dict({n: v.to(dev) for n, v in cpu.state_dict().items()})
    assert sum(isinstance(m, WeightOnlyLinear) for m in card.modules()) == 15
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, 128, (n,)).astype(np.int64),
             SamplingParams(max_new_tokens=20)) for n in (9, 30, 17, 44)]
    eng = Engine(card, max_slots=4, page_size=16, max_context=96,
                 cache_dtype="float32", multi_tick=k)
    eng.run(reqs)                       # captures the graphs at k = 8
    monitor.reset()
    launches = pa.paged_decode.launches
    ticks = eng.decode_ticks
    outs = eng.run(reqs)
    snap = monitor.snapshot()
    n_pd = pa.paged_decode.launches - launches
    assert n_pd == (eng.decode_ticks - ticks) * 2
    assert snap.get("kernels.decode.paged_cuda") == n_pd
    assert not any(v for n, v in snap.items() if n.endswith("_plain"))
    for (prompt, _), o in zip(reqs, outs):
        assert o.ok and len(o.token_ids) == 20
        seq = np.concatenate([prompt, np.asarray(o.token_ids[:-1])])
        with torch.no_grad():
            want = cpu(torch.from_numpy(seq[None]))[0, len(prompt) - 1:]
        agree = float((torch.tensor(o.token_ids) == want.argmax(-1))
                      .float().mean())
        assert agree >= 0.97, agree


@pytest.mark.parametrize("d", [64, 128])
def test_profiler_device_view_counts_the_wgmma_kernels(dev, tmp_path, d):
    """One profiled bf16 flash forward and backward: the profiler's
    device view (CUPTI, through ``paddle_tpu_torch.profiler``) lists the
    wgmma forward, dQ and dK/dV kernels with the launches their wrappers
    counted, and the exported chrome trace's device lane the same."""
    from paddle_tpu_torch import profiler as P
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (torch.randn(2, 256, 4, d, generator=g, device=dev)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    torch.cuda.synchronize()

    def counts():
        return (fa.flash_fwd.launches, fa.flash_bwd.launches_dq,
                fa.flash_bwd.launches_dkv)
    before = counts()
    with P.Profiler(targets=[P.ProfilerTarget.CPU, P.ProfilerTarget.GPU],
                    log_dir=str(tmp_path / "log"),
                    on_trace_ready=P.export_chrome_tracing(
                        str(tmp_path))) as p:
        with P.RecordEvent("fwd_bwd"):
            out = fa.flash_attention_arrays(q, k, v, causal=True)
            out.float().sum().backward()
        torch.cuda.synchronize()
    want = {name: after - b for name, after, b in zip(
        ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
         "flash_bwd_dkv_wgmma_kernel"), counts(), before)}
    assert set(want.values()) == {1}
    view = p.statistic_data.kernel_stats
    assert {name: view[name]["calls"] for name in want} == want
    assert all(view[name]["total_ms"] > 0 for name in want)
    trace = P.load_profiler_result(p.last_trace_path)
    lane = [e["name"] for e in trace["traceEvents"]
            if e.get("cat") == "kernel"]
    assert {name: lane.count(name) for name in want} == want
    assert "fwd_bwd" not in lane and "Device Summary" in p.summary()


# -- paddle.vision's detection ops: the card against the CPU path -----------

def _vision_ops():
    from paddle_tpu_torch.vision import ops
    return ops


def _card_vs_cpu(fn, inputs, grad_of=()):
    """fn(*inputs) on the card and on the CPU: floating outputs and the
    gradients of sum(out * w) in ``grad_of`` within 1e-4 of the scale,
    integer outputs equal."""
    res = []
    for d in ("cuda", "cpu"):
        ins = [t.to(d).requires_grad_(i in grad_of) if torch.is_tensor(t)
               else t for i, t in enumerate(inputs)]
        outs = fn(*ins)
        outs = [o._data for o in (outs if isinstance(outs, (tuple, list))
                                  else (outs,))]
        grads = []
        if grad_of:
            g = torch.Generator().manual_seed(0)
            loss = sum((o * torch.randn(tuple(o.shape), generator=g).to(d))
                       .sum() for o in outs if o.is_floating_point())
            grads = [x.cpu() for x in torch.autograd.grad(
                loss, [ins[i] for i in grad_of])]
        res.append(([o.detach().cpu() for o in outs], grads))
    (card, card_g), (cpu, cpu_g) = res
    for a, b in zip(card, cpu):
        if a.is_floating_point():
            _close(a, b, 1e-4)
        else:
            assert torch.equal(a, b)
    for a, b in zip(card_g, cpu_g):
        _close(a, b, 1e-4)


def _boxes(g, n, size, lo=2.0, hi=24.0):
    xy = torch.rand(n, 2, generator=g) * size
    wh = lo + torch.rand(n, 2, generator=g) * (hi - lo)
    return torch.cat([xy, xy + wh], 1)


@pytest.mark.parametrize("op", ["roi_align", "roi_pool", "psroi_pool"])
def test_vision_roi_ops_on_card_match_cpu(dev, op, monkeypatch):
    ops = _vision_ops()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 2 * 3 * 3, 20, 26, generator=g)
    # random boxes, and boxes on the map's edges whose bins and samples
    # fall on whole pixels (an ulp there moves a pixel)
    boxes = torch.cat([_boxes(g, 9, 80.0), torch.tensor(
        [[0.0, 0.0, 103.0, 79.0], [0.0, 0.0, 55.0, 27.0],
         [8.0, 4.0, 63.0, 59.0]])])
    num = torch.tensor([7, 5], dtype=torch.int32)
    monkeypatch.setattr(ops, "CHUNK_BYTES", 4096)    # several chunks
    _card_vs_cpu(lambda a, b: getattr(ops, op)(a, b, num, 3, 0.25),
                 [x, boxes], (0,))


def test_vision_nms_on_card_matches_cpu(dev):
    ops = _vision_ops()
    g = torch.Generator().manual_seed(2)
    boxes = _boxes(g, 700, 200.0, 8.0, 60.0)
    scores = torch.rand(700, generator=g)
    for thr, top_k in ((0.7, None), (0.3, 50)):
        keep = [ops.nms(boxes.to(d), thr, scores.to(d), top_k=top_k)
                ._data.cpu() for d in ("cuda", "cpu")]
        assert torch.equal(keep[0], keep[1])
        assert keep[0].device.type == "cpu" and (keep[0] >= 0).any()


def test_vision_yolo_ops_on_card_match_cpu(dev):
    ops = _vision_ops()
    g = torch.Generator().manual_seed(3)
    cls, anchors = 6, [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    x = torch.randn(2, 3 * (5 + cls), 8, 8, generator=g)
    img = torch.tensor([[256, 256], [200, 240]], dtype=torch.int32)
    _card_vs_cpu(lambda a, im: ops.yolo_box(a, im, anchors[:6], cls, 0.3,
                                            32), [x, img], (0,))
    gt = torch.zeros(2, 7, 4)
    gt[:, :5, :2] = torch.rand(2, 5, 2, generator=g) * 0.9 + 0.05
    gt[:, :5, 2:] = torch.rand(2, 5, 2, generator=g) * 0.5 + 0.02
    label = torch.randint(0, cls, (2, 7), generator=g)
    _card_vs_cpu(lambda a, b, lab: ops.yolo_loss(
        a, b, lab, anchors, [3, 4, 5], cls, 0.7, 32), [x, gt, label], (0,))


@pytest.mark.parametrize("v2", [False, True])
def test_vision_deform_conv2d_on_card_matches_cpu(dev, v2):
    ops = _vision_ops()
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8, 9, 11, generator=g)
    off = torch.randn(2, 18, 9, 11, generator=g) * 1.5
    w = torch.randn(6, 8, 3, 3, generator=g) * 0.2
    inputs = [x, off, w] + ([torch.rand(2, 9, 9, 11, generator=g)]
                            if v2 else [])
    _card_vs_cpu(lambda a, o, wt, *m: ops.deform_conv2d(
        a, o, wt, padding=1, mask=m[0] if m else None), inputs,
        tuple(range(len(inputs))))


def test_vision_host_ops_return_on_the_card(dev):
    ops = _vision_ops()
    g = torch.Generator().manual_seed(5)
    b = torch.stack([_boxes(g, 30, 50.0) for _ in range(2)])
    s = torch.rand(2, 4, 30, generator=g)
    outs = [ops.multiclass_nms3(b.to(d), s.to(d), score_threshold=0.3,
                                nms_threshold=0.5) for d in ("cuda", "cpu")]
    for a, c in zip(*outs):
        assert a._data.device.type == "cuda"
        assert torch.equal(a._data.cpu(), c._data)


def test_vision_resnet18_train_batch_on_card_matches_cpu(dev):
    """One Model.train_batch of resnet18 (f32, cuDNN with TF32 off) on the
    card and on the CPU with the card's weights: the loss, every
    parameter and running statistic after the step within 1e-4 of its
    scale."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place as place_mod
    from paddle_tpu_torch.vision import models
    prev, cudnn_tf32 = place_mod._current_place, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        g = torch.Generator().manual_seed(6)
        x = torch.randn(4, 3, 64, 64, generator=g)
        y = torch.randint(0, 10, (4,), generator=g)
        paddle.set_device("gpu")
        card_net = models.resnet18(num_classes=10)
        paddle.set_device("cpu")
        cpu_net = models.resnet18(num_classes=10)
        cpu_net.set_state_dict(card_net.state_dict())
        res = []
        for d, net in (("gpu", card_net), ("cpu", cpu_net)):
            paddle.set_device(d)
            model = paddle.Model(net)
            model.prepare(paddle.optimizer.Momentum(
                0.01, parameters=net.parameters(),
                weight_decay=paddle.regularizer.L2Decay(1e-4)),
                paddle.nn.CrossEntropyLoss())
            loss = model.train_batch([paddle.to_tensor(x)],
                                     paddle.to_tensor(y))[0]
            res.append((loss, {k: v._data.cpu()
                               for k, v in net.state_dict().items()}))
        assert abs(res[0][0] - res[1][0]) <= 1e-4 * max(1.0, res[1][0])
        for k, v in res[0][1].items():
            _close(v, res[1][1][k], 1e-4)
    finally:
        place_mod._current_place = prev
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


# -- fft / signal / audio, text.viterbi, geometric, sparse, distribution ---

def _surface_card_vs_cpu(fn, arrays, grad_of=(), tol=1e-4):
    """fn(*Tensors) of the port's surface on the card and on the CPU, the
    same numpy inputs: every floating output (complex ones as real and
    imaginary parts) and the gradients of sum(out * w) in ``grad_of``
    within ``tol`` of the scale; integer outputs equal."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place as place_mod
    prev, cudnn_tf32 = place_mod._current_place, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # f32 convolutions, as the CPU
    res = []
    try:
        for d in ("gpu", "cpu"):
            paddle.set_device(d)
            ins = [paddle.to_tensor(a, dtype=str(a.dtype),
                                    stop_gradient=i not in grad_of)
                   if isinstance(a, np.ndarray) else a
                   for i, a in enumerate(arrays)]
            outs = fn(*ins)
            outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
            datas = [o._data.resolve_conj().resolve_neg() for o in outs]
            grads = []
            if grad_of:
                g = torch.Generator().manual_seed(0)
                loss = 0
                for o in datas:
                    if o.is_complex():
                        o = torch.view_as_real(o)
                    if o.is_floating_point() and o.requires_grad:
                        w = torch.randn(tuple(o.shape), generator=g)
                        loss = loss + torch.where(
                            torch.isfinite(o), o * w.to(o.device),
                            torch.zeros_like(o)).sum()
                xs = [ins[i]._data for i in grad_of]
                grads = [torch.zeros_like(x).cpu() if gr is None
                         else gr.cpu() for x, gr in zip(
                             xs, torch.autograd.grad(loss, xs,
                                                     allow_unused=True))]
            res.append(([o.detach().cpu() for o in datas], grads))
    finally:
        place_mod._current_place = prev
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    (card, card_g), (cpu, cpu_g) = res
    for a, b in list(zip(card, cpu)) + list(zip(card_g, cpu_g)):
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        if a.is_floating_point():
            # infinities (an empty segment's fill, a density outside its
            # support) where the CPU has them, the finite values close
            fin = torch.isfinite(b)
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            inf = torch.isinf(b)
            assert torch.equal(a[inf], b[inf])
            if fin.any():
                _close(a[fin], b[fin], tol)
        else:
            assert torch.equal(a, b)


def _np_rand(*shape, seed=0, lo=-1.0, hi=1.0):
    import numpy as np
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("bos_eos", [True, False])
def test_text_viterbi_on_card_matches_cpu(dev, bos_eos):
    import numpy as np
    import paddle_tpu_torch as paddle
    emis, trans = _np_rand(4, 20, 9, seed=1), _np_rand(9, 9, seed=2)
    lens = np.array([20, 7, 1, 13], np.int64)
    _surface_card_vs_cpu(lambda e, t, n: paddle.text.viterbi_decode(
        e, t, n, bos_eos), [emis, trans, lens], grad_of=(0, 1))


def test_bert_crf_tiny_on_card_matches_cpu(dev):
    """A 2-layer BertModel -> Linear -> ViterbiDecoder at batch 3 with
    padding, the card's weights on the CPU: emissions within 1e-4 of
    their scale, the paths equal."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.text.models import BertConfig, BertModel
    cfg = BertConfig.tiny(vocab=300, hidden=64, layers=2, heads=4)
    nets = {"cuda": BertModel(cfg, seed=3).eval()}
    nets["cpu"] = BertModel(cfg, device="cpu").eval()
    nets["cpu"].load_state_dict({k: v.cpu() for k, v in
                                 nets["cuda"].state_dict().items()})
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 300, (3, 32))
    lens = np.array([32, 9, 20])
    am = (np.arange(32)[None] < lens[:, None]).astype(np.int64)
    w = torch.from_numpy(_np_rand(9, 64, seed=5))
    trans = _np_rand(9, 9, seed=6)
    out = {}
    with torch.no_grad():
        for d, net in nets.items():
            seq = net(torch.from_numpy(ids).to(d),
                      attention_mask=torch.from_numpy(am).to(d))[0]
            em = seq @ w.to(d).T
            dec = paddle.text.ViterbiDecoder(paddle.to_tensor(
                torch.from_numpy(trans).to(d)))
            sc, path = dec(paddle.to_tensor(em),
                           paddle.to_tensor(torch.from_numpy(lens).to(d)))
            out[d] = (em.cpu(), sc._data.cpu(), path._data.cpu())
    _close(out["cuda"][0], out["cpu"][0], 1e-4)
    _close(out["cuda"][1], out["cpu"][1], 1e-4)
    assert torch.equal(out["cuda"][2], out["cpu"][2])


@pytest.mark.parametrize("name,cplx,kw", [
    ("fft", True, {}), ("rfft", False, dict(norm="ortho")),
    ("irfft", True, dict(n=14)), ("hfft", True, {}), ("ihfft", False, {}),
    ("fft2", True, dict(norm="forward")), ("rfftn", False, {}),
    ("irfftn", True, {}), ("hfft2", True, {}), ("ihfft2", False, {})])
def test_fft_on_card_matches_cpu(dev, name, cplx, kw):
    import paddle_tpu_torch as paddle
    ins = [_np_rand(3, 8, 8, seed=7)] + ([_np_rand(3, 8, 8, seed=8)]
                                          if cplx else [])

    def fn(*parts):
        x = paddle.complex(*parts) if cplx else parts[0]
        return getattr(paddle.fft, name)(x, **kw)
    _surface_card_vs_cpu(fn, ins, grad_of=tuple(range(len(ins))))


def test_stft_istft_and_features_on_card_match_cpu(dev):
    import paddle_tpu_torch as paddle
    x = _np_rand(2, 4000, seed=9)

    def fn(a):
        win = paddle.audio.functional.get_window("hann", 64)
        spec = paddle.signal.stft(a, 64, 16, window=win)
        back = paddle.signal.istft(spec, 64, 16, window=win, length=4000)
        lm = paddle.audio.features.LogMelSpectrogram(
            sr=16000, n_fft=64, hop_length=16, n_mels=16, top_db=80.0)(a)
        mf = paddle.audio.features.MFCC(sr=16000, n_mfcc=13, n_mels=16,
                                        n_fft=64, hop_length=16)(a)
        return spec, back, lm, mf
    _surface_card_vs_cpu(fn, [x], grad_of=(0,), tol=1e-3)


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_message_passing_on_card_matches_cpu(dev, reduce_op):
    import numpy as np
    import paddle_tpu_torch as paddle
    rng = np.random.default_rng(10)
    src = rng.integers(0, 50, 400).astype(np.int64)
    dst = rng.integers(0, 45, 400).astype(np.int64)
    x, e = _np_rand(50, 8, seed=11), _np_rand(400, 1, seed=12)
    _surface_card_vs_cpu(lambda a, w, s, d: paddle.geometric.send_ue_recv(
        a, w, s, d, "mul", reduce_op), [x, e, src, dst], grad_of=(0, 1))
    seg = np.sort(rng.integers(0, 30, 50)).astype(np.int64)
    _surface_card_vs_cpu(lambda a, s: getattr(
        paddle.geometric, f"segment_{reduce_op}")(a, s), [x, seg],
        grad_of=(0,))


def test_gcn_routes_on_card_match_cpu(dev):
    """Two aggregation routes of a GCN layer (send_ue_recv, sparse.matmul
    of the COO adjacency) on the card against the CPU, gradients in the
    weights included."""
    import numpy as np
    import paddle_tpu_torch as paddle
    rng = np.random.default_rng(13)
    n = 80
    src = np.concatenate([rng.integers(0, n, 300), np.arange(n)])
    dst = np.concatenate([rng.integers(0, n, 300), np.arange(n)])
    wts = rng.uniform(0.1, 1.0, len(src)).astype(np.float32)
    x, w1 = _np_rand(n, 12, seed=14), _np_rand(12, 6, seed=15)

    def fn(a, w, s, d, ew):
        h = paddle.matmul(a, w)
        adj = paddle.sparse.sparse_coo_tensor(paddle.stack([d, s]),
                                              ew[:, 0], [n, n])
        return (paddle.geometric.send_ue_recv(h, ew, s, d, "mul", "sum",
                                              out_size=n),
                paddle.sparse.matmul(adj, h))
    _surface_card_vs_cpu(fn, [x, w1, src.astype(np.int64),
                              dst.astype(np.int64), wts[:, None]],
                         grad_of=(0, 1))


def test_sparse_conv_pool_batchnorm_on_card_match_cpu(dev):
    import numpy as np
    import paddle_tpu_torch as paddle
    rng = np.random.default_rng(16)
    dense = np.zeros((1, 6, 8, 8, 3), np.float32)
    flat = rng.choice(6 * 8 * 8, 40, replace=False)
    dense.reshape(-1, 3)[flat] = rng.standard_normal((40, 3))
    paddle.seed(17)
    from paddle_tpu_torch.core import place as place_mod
    prev = place_mod._current_place
    paddle.set_device("cpu")
    state = paddle.sparse.nn.SubmConv3D(3, 4, 3, padding=1).state_dict()
    state = {k: v.numpy() for k, v in state.items()}
    place_mod._current_place = prev

    def fn(a):
        conv = paddle.sparse.nn.SubmConv3D(3, 4, 3, padding=1)
        conv.set_state_dict(state)
        y = conv(paddle.sparse.to_sparse_coo(a))
        z = paddle.sparse.nn.BatchNorm(4)(y)
        p = paddle.sparse.nn.MaxPool3D(2)(z)
        return y.to_dense(), z.to_dense(), p.to_dense()
    _surface_card_vs_cpu(fn, [dense], grad_of=(0,))


@pytest.mark.parametrize("name", ["Normal", "Categorical", "Bernoulli",
                                  "StudentT", "MultivariateNormal",
                                  "Binomial", "Uniform"])
def test_distributions_on_card_match_cpu(dev, name):
    import numpy as np
    import paddle_tpu_torch as paddle
    a, b = _np_rand(16, 8, seed=18), _np_rand(16, 8, seed=19, lo=0.5, hi=2)
    v = _np_rand(16, 8, seed=20, lo=-2, hi=2)
    cov = (np.eye(8) * 2 + 0.3).astype(np.float32)

    def fn(p, q, val):
        D = paddle.distribution
        dist, other = {
            "Normal": lambda: (D.Normal(p, q), D.Normal(q, q + 1)),
            "Categorical": lambda: (D.Categorical(p), D.Categorical(q)),
            "Bernoulli": lambda: (D.Bernoulli(logits=p),
                                  D.Bernoulli(logits=q)),
            "StudentT": lambda: (D.StudentT(q + 3, p, q), None),
            "MultivariateNormal": lambda: (D.MultivariateNormal(
                p[0], covariance_matrix=paddle.to_tensor(cov)), None),
            "Binomial": lambda: (D.Binomial(np.full((16, 8), 7),
                                            paddle.nn.functional.sigmoid(p)),
                                 None),
            "Uniform": lambda: (D.Uniform(p - 3, q + 1),
                                D.Uniform(p - 4, q + 2)),
        }[name]()
        val_ = paddle.floor(paddle.abs(val) * 3) if name == "Binomial" \
            else (paddle.cast(paddle.abs(val) * 3, "int64")
                  if name == "Categorical" else val)
        outs = [dist.log_prob(val_[:, 0] if name == "Categorical"
                              else val_)]
        if name != "MultivariateNormal":
            outs.append(dist.entropy())
        if other is not None:
            outs.append(paddle.distribution.kl_divergence(dist, other))
        return outs
    _surface_card_vs_cpu(fn, [a, b, v], grad_of=(0, 1))


def test_distribution_samples_on_card(dev):
    """Draws on the card within 4 standard errors of the analytic mean,
    reproducible under seed."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place as place_mod
    prev = place_mod._current_place
    paddle.set_device("gpu")
    try:
        D = paddle.distribution
        for dist, mean, var in ((D.Normal(np.float32(1.0), np.float32(2.0)),
                                 1.0, 4.0),
                                (D.Gamma(np.float32(3.0), np.float32(2.0)),
                                 1.5, 0.75),
                                (D.Poisson(np.float32(4.0)), 4.0, 4.0),
                                (D.Exponential(np.float32(2.0)), 0.5, 0.25)):
            paddle.seed(21)
            s = dist.sample([65536])
            assert s.place.device_type == "gpu"
            s = s.numpy().astype(np.float64)
            paddle.seed(21)
            assert np.array_equal(dist.sample([65536]).numpy(), s)
            assert abs(s.mean() - mean) <= 4 * np.sqrt(var / len(s))
    finally:
        place_mod._current_place = prev


# -- jit.to_static: the flash custom ops and a compiled surface attention ----

@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128)])
def test_flash_lse_and_bwd_custom_ops_on_the_card(dev, dtype, d):
    """``paddle_tpu_torch::flash_fwd_lse`` and ``::flash_bwd`` (what a
    compiled graph holds) on the card: the same launches as ``flash_fwd``
    / ``flash_bwd``, counted once each, and the plain versions' values
    within 1e-4 (f32) / 1e-2 (bf16) of their scale, under key bands."""
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v, do = (torch.randn(2, 128, 4, d, generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    keep = torch.arange(128, device=dev)[None] < torch.tensor(
        [128, 77], device=dev)[:, None]
    se = fa._normalize_startend(
        torch.where(keep, 128, 0).to(torch.int32)[:, None, :, None],
        128, 128, False)
    s = d ** -0.5
    n_fwd, n_dq = fa.flash_fwd.launches, fa.flash_bwd.launches_dq
    out, lse = torch.ops.paddle_tpu_torch.flash_fwd_lse(q, k, v, se, False,
                                                       s, None)
    dq, dk, dv = torch.ops.paddle_tpu_torch.flash_bwd(q, k, v, out, lse, do,
                                                      se, False, s, None)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == n_fwd + 1
    assert fa.flash_bwd.launches_dq == n_dq + 1
    def t(x):                   # the plain versions in f32, as above
        return x.transpose(1, 2).float()
    want, want_lse = fa.flash_plain(t(q), t(k), t(v), False, s, None, se,
                                    return_lse=True)
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    _close(out, want.transpose(1, 2), rtol)
    _close(lse, want_lse, 1e-5)
    grads = fa.flash_bwd_plain(t(q), t(k), t(v), t(out), lse, t(do), False,
                               s, None, se)
    for got, ref in zip((dq, dk, dv), grads):
        _close(got, ref.transpose(1, 2), rtol)


def test_to_static_masked_attention_on_the_wgmma_route(dev):
    """A surface TransformerEncoderLayer under a key mask through
    ``paddle.jit.to_static`` (Inductor) on the card, O1 bf16: each call's
    forward and backward launch the wgmma forward, dQ and dK/dV once from
    the compiled graphs, dispatch no surface op eagerly, and the loss
    and gradients agree with the eager layer's (1e-2 of their scale)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import monitor, nn
    from paddle_tpu_torch.core import dispatch
    from paddle_tpu_torch.core import place as place_mod
    prev = place_mod._current_place
    paddle.set_device("gpu")
    try:
        paddle.seed(0)
        layer = nn.TransformerEncoderLayer(256, 4, 512, dropout=0.0,
                                           activation="gelu")
        g = torch.Generator().manual_seed(2)
        x = paddle.to_tensor(torch.randn(4, 128, 256, generator=g))
        keep = paddle.to_tensor((torch.arange(128)[None] < torch.tensor(
            [128, 100, 64, 77])[:, None])[:, None, None, :])
        def loss_of(x, keep):
            return layer(x, src_mask=keep).astype("float32").mean()
        sloss = paddle.jit.to_static(loss_of)

        def run(fn):
            with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = fn(x, keep)
            loss.backward()
            grads = {n: p.grad._data.float().clone()
                     for n, p in layer.named_parameters()}
            layer.clear_gradients()
            return float(loss), grads
        run(sloss)                                    # compiles
        monitor.reset()
        n0 = dispatch.op_count
        loss_c, grads_c = run(sloss)
        torch.cuda.synchronize()
        snap = monitor.snapshot()
        assert dispatch.op_count == n0
        for k in ("fwd", "dq", "dkv"):
            assert snap.get(f"kernels.flash.{k}_cuda_tc_wgmma") == 1, snap
        assert not any(v for k, v in snap.items()
                       if k.endswith("_plain") or ".sdpa." in k), snap
        assert not sloss._eager_sigs and len(sloss._cache) == 1
        loss_e, grads_e = run(loss_of)
        assert abs(loss_c - loss_e) <= 1e-2 * max(1.0, abs(loss_e))
        for n, ge in grads_e.items():
            _close(grads_c[n], ge, 1e-2)
    finally:
        place_mod._current_place = prev


# -- collective training: NCCL on a world of one, gloo ranks sharing the card

def test_distributed_nccl_world_of_one(dev):
    """One rank on one card: the backend rule picks NCCL; every
    collective keeps the tensor on the card and stages nothing."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed import env
    dist.init_parallel_env()
    try:
        assert env.backend() == "nccl" and dist.get_backend() == "NCCL"
        monitor.reset()
        x = torch.randn(64, 64, device=dev).bfloat16()
        for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
            t = x.clone()
            dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
            assert torch.equal(t, x), op
        got = []
        dist.all_gather(got, x)
        t = torch.empty_like(x)
        dist.reduce_scatter(t, [x])
        u = torch.empty_like(x)
        dist.alltoall_single(u, x)
        v = x.clone()
        dist.broadcast(v, src=0)
        dist.barrier()
        assert all(torch.equal(a, x) for a in (got[0], t, u, v))
        assert dist.communication.staged_bytes() == {}
        assert monitor.counter("distributed.calls.all_reduce").get() == 5
    finally:
        dist.destroy_process_group()


def test_distributed_gloo_ranks_stage_cuda_tensors(dev, tmp_path):
    """Two ranks sharing the card: gloo, each CUDA tensor staged through
    pinned host memory and copied back (the counters count both ways)."""
    import torch_dist_worker as W
    if torch.cuda.device_count() > 1:
        pytest.skip("with a card a rank the backend rule picks NCCL")
    (tmp_path / "inputs.pkl").write_bytes(__import__("pickle").dumps({}))
    ranks = W.join_world(W.start_world(2, "cuda_gloo", tmp_path, None),
                         str(tmp_path), timeout=180)
    n = 1 << 16
    for r, out in enumerate(ranks):
        assert out["backend"] == "gloo" and out["device"] == "cuda:0"
        assert out["on_cuda"]
        assert (out["all_reduce"] == 3.0).all()
        assert [g.tolist() for g in out["all_gather"]] == [[0.0] * 4,
                                                            [1.0] * 4]
        assert (out["broadcast"] == 1.0).all()
        assert out["staged"] == {"all_reduce": 8 * n, "all_gather": 48,
                                 "broadcast": 32 if r == 1 else 16}


def test_distributed_nccl_refuses_two_ranks_on_one_card(dev, tmp_path):
    """Why two ranks on one card run gloo: NCCL refuses them."""
    import torch_dist_worker as W
    if torch.cuda.device_count() > 1:
        pytest.skip("needs exactly one card")
    (tmp_path / "inputs.pkl").write_bytes(__import__("pickle").dumps({}))
    with pytest.raises(RuntimeError) as exc:
        W.join_world(W.start_world(2, "cuda_nccl_shared", tmp_path, "nccl"),
                     str(tmp_path), timeout=120)
    assert "duplicate gpu" in str(exc.value).lower(), str(exc.value)[-3000:]


# -- pipeline parallelism: the flash kernels at a microbatch's shape ------

def test_pipeline_microbatch_flash_matches_plain(dev):
    """A pipeline stage calls the flash kernels on one microbatch: phase
    9's LLaMA at accumulate_steps 4 gives [3, 1024, 32, 128] bf16, causal.
    The forward with logsumexp and both backward kernels against their
    plain versions there."""
    g = torch.Generator().manual_seed(29)
    q, k, v, do = (torch.randn(3, 1024, 32, 128, generator=g).to(
        dev, torch.bfloat16) for _ in range(4))
    scale = 128 ** -0.5
    t = lambda x: x.transpose(1, 2).float()
    n = (fa.flash_fwd.launches, fa.flash_bwd.launches_dq,
         fa.flash_bwd.launches_dkv)
    out, lse = fa.flash_fwd(q, k, v, True, scale, None, None, want_lse=True)
    want, want_lse = fa.flash_plain(t(q), t(k), t(v), True, scale, None,
                                    None, return_lse=True)
    _close(out, want.transpose(1, 2), 1e-2)
    _close(lse, want_lse, 1e-5)
    o = want.transpose(1, 2).to(torch.bfloat16)
    got = fa.flash_bwd(q, k, v, o, want_lse, do, True, scale, None, None)
    ref = fa.flash_bwd_plain(t(q), t(k), t(v), t(o), want_lse, t(do), True,
                             scale, None, None)
    torch.cuda.synchronize()
    for g_, r_ in zip(got, ref):
        _close(g_, r_.transpose(1, 2), 1e-2)
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches_dq,
            fa.flash_bwd.launches_dkv) == tuple(x + 1 for x in n)


def test_pipeline_mpmd_step_on_the_card_matches_the_cpu(dev):
    """A 2-stage LLaMA pipe in the MPMD and MPMD-ZBH1 modes, both stages
    on the card: one f32 train_batch (SGD at lr 0, so the gradients stay
    in ``.grad``) against the same step on the CPU: the loss within 1e-5
    of its value, each parameter's gradient within 1e-4 of its norm (the
    norm of the difference) and 1e-3 of its max entry (any entry); each
    microbatch runs each layer's flash forward, dQ and dK/dV once (the
    zero-bubble W events run none of them again)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineParallel
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.text.models import LlamaConfig, build_llama_pipe
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=4, heads=4)
    ids = torch.randint(0, 256, (4, 64), generator=torch.Generator()
                        .manual_seed(3))
    # the CPU's weights on both (a CUDA generator draws other numbers)
    state = build_llama_pipe(cfg, num_stages=2, device="cpu",
                             seed=1).state_dict()

    def counts():
        return (fa.flash_fwd.launches, fa.flash_bwd.launches_dq,
                fa.flash_bwd.launches_dkv)

    for mode in ("MPMD", "MPMD-ZBH1"):
        runs = {}
        for d in ("cpu", "cuda"):
            s = fleet.DistributedStrategy()
            s.pipeline_configs = {"accumulate_steps": 2,
                                  "schedule_mode": mode}
            pipe = build_llama_pipe(cfg, num_stages=2, device=d, seed=1)
            pipe.load_state_dict(state)
            model = PipelineParallel(pipe, strategy=s)
            n = counts()
            loss = model.train_batch((ids, ids),
                                     SGD(0.0, parameters=model.parameters()))
            runs[d] = (float(loss), {k: p.grad.detach().cpu() for k, p in
                                     model.named_parameters()},
                       tuple(b - a for a, b in zip(n, counts())))
        (want, want_g, _), (got, got_g, launched) = runs["cpu"], runs["cuda"]
        assert abs(got - want) <= 1e-5 * abs(want), (mode, got, want)
        for k, g in want_g.items():
            diff = (got_g[k].float() - g.float())
            assert float(diff.norm()) <= 1e-4 * float(g.norm()), (mode, k)
            assert float(diff.abs().max()) <= 1e-3 * float(g.abs().max()), \
                (mode, k)
        assert launched == (cfg.num_hidden_layers * 2,) * 3, (mode, launched)


# -- sequence parallelism: the ring and mp=2 + SP on the card -------------

def _ring_cases():
    import numpy as np
    rng = np.random.default_rng(31)
    out = []
    for causal, h_kv, window in ((False, 4, None), (True, 2, None),
                                 (True, 1, 5)):
        f = np.float32
        out.append(dict(
            causal=causal, window=window,
            q=rng.standard_normal((2, 4, 64, 32)).astype(f),
            k=rng.standard_normal((2, h_kv, 64, 32)).astype(f),
            v=rng.standard_normal((2, h_kv, 64, 32)).astype(f),
            cot=rng.standard_normal((2, 4, 64, 32)).astype(f)))
    return out


def test_ring_on_the_card_matches_the_cpu(dev, tmp_path):
    """Two ranks sharing the card (gloo), each its chunk of the sequence:
    the ring's output and q / k / v gradients against the same ring run
    on the CPU in one process (``MpmdRingExecutor``, the same hop code),
    within 1e-4 of each tensor's largest value (f32; the card's and the
    CPU's einsums sum in other orders); k / v staged through host memory
    by send / recv."""
    import pickle

    import torch_dist_worker as W
    from paddle_tpu_torch.distributed.mpmd_runtime import MpmdRingExecutor
    if torch.cuda.device_count() > 1:
        pytest.skip("with a card a rank the backend rule picks NCCL")
    cases = _ring_cases()
    (tmp_path / "inputs.pkl").write_bytes(pickle.dumps(
        dict(ring_cases=cases)))
    ranks = W.join_world(W.start_world(2, "cuda_ring", tmp_path, None),
                         str(tmp_path), timeout=240)
    for i, case in enumerate(cases):
        ex = MpmdRingExecutor(2, causal=case["causal"],
                              window=case["window"],
                              devices=[torch.device("cpu")])
        out, grads = ex.run(*(torch.from_numpy(case[n])
                              for n in ("q", "k", "v")),
                            dout=torch.from_numpy(case["cot"]))
        want = dict(out=out, dq=grads[0], dk=grads[1], dv=grads[2])
        for r, got in enumerate(ranks):
            rec = got["ring"][i]
            assert rec["on_cuda"]
            for name, w in want.items():
                w = w[:, :, r * 32:(r + 1) * 32]
                _close(torch.from_numpy(rec[name]), w, 1e-4)
    for got in ranks:
        assert got["backend"] == "gloo"
        assert got["staged"].get("send", 0) > 0 and \
            got["staged"].get("recv", 0) > 0


def test_sequence_parallel_mp2_on_one_card(dev, tmp_path):
    """Two ranks sharing the card (gloo), mp=2 with ``sequence_parallel``:
    the fused loss within 1e-5 (relative) and every gradient within
    closeness's f32 gate (1e-4 of max(1, its max)) of an mp=1 model from
    the same seed."""
    import pickle

    import torch_dist_worker as W
    if torch.cuda.device_count() > 1:
        pytest.skip("with a card a rank the backend rule picks NCCL")
    (tmp_path / "inputs.pkl").write_bytes(pickle.dumps({}))
    ranks = W.join_world(W.start_world(2, "cuda_sp", tmp_path, None),
                         str(tmp_path), timeout=240)
    r0 = ranks[0]
    assert all(r["backend"] == "gloo" for r in ranks)
    assert abs(r0["loss"] - r0["want_loss"]) <= 1e-5 * abs(r0["want_loss"])
    assert ranks[1]["loss"] == r0["loss"]
    worst = max(r0["ratios"], key=r0["ratios"].get)
    assert r0["ratios"][worst] <= 1.0, (worst, r0["ratios"][worst])
