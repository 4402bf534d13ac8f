"""The port's CUDA kernels held to their plain PyTorch versions on the
card, at small shapes that cover the edges (dead slots, ragged page and
tile edges, GQA, windows, every pool dtype). They need an NVIDIA GPU
and nvcc, so they skip elsewhere; on the card run

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

(chip_smoke.py repeats the comparison at the serving shapes.)
Tolerances: 1e-4 relative to the output's scale for f32, 1e-2 for half
precision outputs (the kernels accumulate in f32; the plain versions sum
in another order).
"""
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


def _train_inputs(dev, name, dtype):
    B, sq, sk, h, hkv, d, causal, window, mask = _TRAIN_CASES[name]
    g = torch.Generator().manual_seed(len(name) * 7 + d)
    q, k, v, do = (torch.randn(B, s_, hh, d, generator=g).to(dev, dtype)
                   for s_, hh in ((sq, h), (sk, hkv), (sk, hkv), (sq, h)))
    se = None
    if mask == "doc":
        se = _doc_bands(sq, [(0, 100), (100, 228), (228, sq)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(_MOE_CASES))
def test_grouped_ffn_kernels_match_plain(dev, dtype, name):
    """The forward, dx and dw kernels against the plain versions (f32 math
    from the same rounded inputs): dead rows of out, dx and dws zero."""
    from paddle_tpu_torch.kernels import moe
    ops, cnt, g, act = _moe_inputs(dev, name, dtype)
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    n = (moe.grouped_ffn_fwd.launches, moe.grouped_ffn_bwd.launches_dx,
         moe.grouped_ffn_bwd.launches_dw)
    out = moe.grouped_ffn_fwd(*ops, cnt, act)
    grads = moe.grouped_ffn_bwd(*ops, cnt, g, act)
    torch.cuda.synchronize()
    assert (moe.grouped_ffn_fwd.launches, moe.grouped_ffn_bwd.launches_dx,
            moe.grouped_ffn_bwd.launches_dw) == (n[0] + 1, n[1] + 1,
                                                 n[2] + 1)
    _close(out, moe.grouped_ffn_plain(*ops, cnt, act), rtol)
    ref = moe.grouped_ffn_bwd_plain(*ops, cnt, g, act)
    for a, b in zip(grads, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, rtol)
    dead = torch.arange(ops[0].shape[1], device=dev)[None] >= cnt[:, None]
    for t in (out, grads[0], grads[5]):
        assert not t[dead].any()


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
