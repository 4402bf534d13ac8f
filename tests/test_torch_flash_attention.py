"""The port's flash attention (paddle_tpu_torch.kernels.flash_attention)
held to the JAX package's ``flash_attention_arrays`` on the CPU, which
routes to its XLA path ``_flash_xla``: the forward, its logsumexp, the
flashmask bands, and the gradients (the port's autograd against
``jax.vjp``).

Tolerance: atol = rtol = 1e-4 on f32 outputs and gradients (the two
frameworks sum in different orders; everything is f32 and small). On the
CPU the ``flash_fwd`` / ``flash_bwd`` wrappers run the plain versions;
the CUDA kernels are held to those plain versions on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py).
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401 — the JAX package's x64 setup
from paddle_tpu.kernels.flash_attention import \
    flash_attention_arrays as jax_flash
from paddle_tpu_torch import monitor
from paddle_tpu_torch.kernels import flash_attention as tfa

TOL = dict(atol=1e-4, rtol=1e-4)

# (sq, sk, h, hkv, causal, window)
CASES = {
    "causal": (16, 16, 4, 4, True, None),
    "full": (16, 16, 4, 4, False, None),
    "bottom_right": (5, 19, 4, 4, True, None),     # sq < sk
    "gqa": (12, 12, 6, 2, True, None),
    "mqa_full": (7, 9, 4, 1, False, None),
    "window": (20, 20, 4, 2, True, 6),
    "window_sq_lt_sk": (6, 17, 2, 2, True, 3),
    "rows_masked": (9, 4, 2, 2, True, None),       # sq > sk: empty rows
}


# flashmask cases: (s, h, hkv, causal, C, h_se, batch of the mask)
FM_CASES = {
    "fm_causal_c1_doc_bcast": (20, 4, 2, True, 1, 1, 1),
    "fm_causal_c2_empty_rows": (20, 4, 2, True, 2, 2, 2),
    "fm_full_c2": (18, 4, 4, False, 2, 1, 2),
    "fm_full_c4_hse_eq_hkv": (18, 4, 2, False, 4, 2, 1),
}


def _startend(rng, s, C, h_se, bse):
    """Raw startend_row_indices [bse, h_se, s, C] int32. C=1: a causal
    document mask; C=2 / C=4: random bands; the first bands of keys 0-2
    mask rows 0-2, so under causal masking rows 0-2 see no key at all."""
    if C == 1:
        idx = np.zeros((bse, h_se, s, 1), np.int32)
        for lo, hi in ((0, 7), (7, 13), (13, s)):
            idx[:, :, lo:hi, 0] = hi
        return idx
    start = rng.integers(0, s, (bse, h_se, s))
    end = np.minimum(start + rng.integers(1, s, (bse, h_se, s)), s)
    start[..., :3], end[..., :3] = 0, 3
    cols = [start, end]
    if C == 4:
        ut0 = rng.integers(0, s // 2, (bse, h_se, s))
        cols += [ut0, np.minimum(ut0 + 4, s)]
    return np.stack(cols, -1).astype(np.int32)


def _fm_inputs(name):
    s, h, hkv, causal, C, h_se, bse = FM_CASES[name]
    rng = np.random.default_rng(len(name) + 100)
    q, k, v = _qkv(rng, s, s, h, hkv)
    return q, k, v, causal, _startend(rng, s, C, h_se, bse)


def _qkv(rng, sq, sk, h, hkv, d=16, b=2):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_flash_matches_jax(name):
    sq, sk, h, hkv, causal, window = CASES[name]
    q, k, v = _qkv(np.random.default_rng(len(name)), sq, sk, h, hkv)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                window=window))
    got = tfa.flash_attention_arrays(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if name == "rows_masked":
        # query rows 0..4 see no key (bottom-right band): exact zeros
        assert not got[:, : sq - sk].any()


def test_wrapper_on_cpu_runs_plain_version():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(0), 8, 8, 2, 2))
    launches = tfa.flash_fwd.launches
    before = monitor.counter("kernels.flash.fwd_plain").get()
    got = tfa.flash_fwd(q, k, v, True, 0.25)
    want = tfa.flash_plain(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), True, 0.25).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tfa.flash_fwd.launches == launches
    assert monitor.counter("kernels.flash.fwd_plain").get() == before + 1


def test_entry_validation():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(0), 4, 4, 4, 2))
    se1 = torch.zeros(2, 1, 4, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="seq_q == seq_k"):
        tfa.flash_attention(q[:, :3], k, v, causal=True,
                            startend_row_indices=se1)
    with pytest.raises(ValueError, match="must divide kv"):
        tfa.flash_attention(q, k, v, causal=True,
                            startend_row_indices=torch.zeros(
                                2, 3, 4, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[batch, kv_heads, seq_k, C\]"):
        tfa.flash_attention(q, k, v, causal=True,
                            startend_row_indices=torch.zeros(
                                2, 1, 5, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="last dim must be 1 or 2"):
        tfa.flash_attention(q, k, v, causal=True,
                            startend_row_indices=torch.zeros(
                                2, 1, 4, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="last dim must be 1, 2 or 4"):
        tfa.flash_attention(q, k, v, causal=False,
                            startend_row_indices=torch.zeros(
                                2, 1, 4, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="batch"):
        tfa.flash_attention(q, k, v, causal=True,
                            startend_row_indices=torch.zeros(
                                3, 1, 4, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, k, v, causal=False, window=2)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, v, causal=True, window=0)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1),
                            v[:, :, :1].expand(-1, -1, 3, -1))


def _masked_logits(q, k, causal, window, scale):
    """Scaled logits [b, h, sq, sk] with NEG_INF on masked pairs, and the
    row validity, in numpy (the JAX package's masking rules)."""
    rep = q.shape[2] // k.shape[2]
    kk = np.repeat(k, rep, axis=2)
    logits = np.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    sq, sk = logits.shape[-2:]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask = np.tril(mask, k=sk - sq)
        if window is not None:
            mask &= ~np.tril(np.ones((sq, sk), bool), k=sk - sq - window)
    return np.where(mask, logits, tfa.NEG_INF), mask.any(-1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_lse_matches_jax_logsumexp(name):
    sq, sk, h, hkv, causal, window = CASES[name]
    q, k, v = _qkv(np.random.default_rng(len(name)), sq, sk, h, hkv)
    scale = 0.25
    logits, valid = _masked_logits(q, k, causal, window, scale)
    want = np.asarray(jax.nn.logsumexp(jnp.asarray(logits), axis=-1))
    want = np.where(valid, want, tfa.NEG_INF)
    out, lse = tfa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal, scale, window,
                             want_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, h, sq)
    np.testing.assert_allclose(lse.numpy(), want, **TOL)
    np.testing.assert_array_equal(
        out.numpy(), tfa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal, scale,
                                   window).numpy())


@pytest.mark.parametrize("name", sorted(FM_CASES))
def test_plain_flashmask_matches_jax(name):
    q, k, v, causal, se = _fm_inputs(name)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                startend_row_indices=jnp.asarray(se)))
    got = tfa.flash_attention_arrays(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, startend_row_indices=torch.from_numpy(se)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if name == "fm_causal_c2_empty_rows":
        assert not got[:, :3].any()      # rows 0-2 see no key: zeros
        bands = tfa._normalize_startend(torch.from_numpy(se), 20, 20, True)
        _, lse = tfa.flash_plain(*(torch.from_numpy(a).transpose(1, 2)
                                   for a in (q, k, v)), causal, 0.25,
                                 se=bands, return_lse=True)
        assert (lse[:, :, :3] == tfa.NEG_INF).all()
        assert (lse[:, :, 3:] > tfa.ROW_INVALID_LSE).all()


def _grads_vs_jax(q, k, v, causal, window=None, se=None):
    w = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window)
    jse = None if se is None else jnp.asarray(se)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(
        a, b, c, startend_row_indices=jse, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(w))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = monitor.counter("kernels.flash.bwd_plain").get()
    out = tfa.flash_attention(
        tq, tk, tv, startend_row_indices=None if se is None
        else torch.from_numpy(se), **kw)
    (out * torch.from_numpy(w)).sum().backward()
    assert monitor.counter("kernels.flash.bwd_plain").get() == before + 1
    for got, ref, n in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        assert got.shape == ref.shape, n
        np.testing.assert_allclose(got.numpy(), ref, err_msg=f"d{n}", **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_grads_match_jax_vjp(name):
    sq, sk, h, hkv, causal, window = CASES[name]
    q, k, v = _qkv(np.random.default_rng(len(name)), sq, sk, h, hkv)
    _grads_vs_jax(q, k, v, causal, window)


@pytest.mark.parametrize("name", sorted(FM_CASES))
def test_flashmask_grads_match_jax_vjp(name):
    q, k, v, causal, se = _fm_inputs(name)
    _grads_vs_jax(q, k, v, causal, se=se)


@pytest.mark.parametrize("name", sorted(CASES) + sorted(FM_CASES))
def test_bwd_plain_matches_autograd_of_plain(name):
    """flash_bwd_plain (the recompute formulas the kernels use) against
    torch.autograd through flash_plain, on [B, H, S, D]."""
    se = None
    if name in FM_CASES:
        q, k, v, causal, raw = _fm_inputs(name)
        window = None
        se = tfa._normalize_startend(torch.from_numpy(raw), q.shape[1],
                                     k.shape[1], causal)
    else:
        sq, sk, h, hkv, causal, window = CASES[name]
        q, k, v = _qkv(np.random.default_rng(len(name)), sq, sk, h, hkv)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).requires_grad_()
                  for a in (q, k, v))
    out, lse = tfa.flash_plain(tq, tk, tv, causal, 0.3, window, se,
                               return_lse=True)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    out.backward(do)
    got = tfa.flash_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                              out.detach(), lse.detach(), do, causal, 0.3,
                              window, se)
    for g, want, n in zip(got, (tq.grad, tk.grad, tv.grad), "qkv"):
        np.testing.assert_allclose(g.numpy(), want.numpy(),
                                   err_msg=f"d{n}", **TOL)


def test_no_grad_forward_saves_nothing_and_writes_no_lse():
    """Under torch.no_grad() (serving) the entry runs the forward alone:
    no autograd node; with a gradient to take it runs _FlashAttnFn."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in
               _qkv(np.random.default_rng(1), 6, 6, 2, 2))
    with torch.no_grad():
        out = tfa.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    out = tfa.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "_FlashAttnFnBackward"


def test_bwd_wrapper_on_cpu_runs_plain_version():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(2), 8, 8, 4, 2))
    out, lse = tfa.flash_fwd(q, k, v, True, 0.25, want_lse=True)
    do = torch.ones_like(out)
    launches = (tfa.flash_bwd.launches_dq, tfa.flash_bwd.launches_dkv)
    before = monitor.counter("kernels.flash.bwd_plain").get()
    dq, dk, dv = tfa.flash_bwd(q, k, v, out, lse, do, True, 0.25)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert (tfa.flash_bwd.launches_dq, tfa.flash_bwd.launches_dkv) == launches
    assert monitor.counter("kernels.flash.bwd_plain").get() == before + 1


def _gqa_group_sum_gap(seed=0, b=2, s=96, h=8, hkv=2, d=64):
    """(port, pallas-style, per-head partials) for dK and dV of a bf16 GQA
    case: the port's dK/dV kernel sums the group's q heads in f32 and
    rounds once; ``_flash_pallas_bwd`` (:675-691) rounds each q head's
    partial to k's dtype, then sums them in f32 and rounds again."""
    g = torch.Generator().manual_seed(seed)
    rep = h // hkv

    def mk(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16).float()
    q, do, k, v = mk(b, h, s, d), mk(b, h, s, d), mk(b, hkv, s, d), \
        mk(b, hkv, s, d)
    o, lse = tfa.flash_plain(q, k, v, True, d ** -0.5, return_lse=True)
    o = o.to(torch.bfloat16).float()
    _, dk, dv = tfa.flash_bwd_plain(q, k, v, o, lse, do, True, d ** -0.5)
    _, dkh, dvh = tfa.flash_bwd_plain(q, k.repeat_interleave(rep, 1),
                                      v.repeat_interleave(rep, 1), o, lse,
                                      do, True, d ** -0.5)
    out = []
    for port, parts in ((dk, dkh), (dv, dvh)):
        parts = parts.reshape(b, hkv, rep, s, d)
        pallas = parts.to(torch.bfloat16).float().sum(2).to(torch.bfloat16)
        out.append((port.to(torch.bfloat16).float(), pallas.float(), parts))
    return out


def test_gqa_dkv_group_sum_differs_by_bf16_rounding_only():
    """Divergence by design (ROADMAP section 3): in bf16 the port's GQA
    dK/dV and the Pallas kernel's differ only by the rounding of the rep
    per-head partials — elementwise within the bf16 unit roundoff 2^-8
    of the partials' magnitudes plus one roundoff on each side's result;
    measured over the whole tensor at under 1e-2 of its largest value."""
    for port, pallas, parts in _gqa_group_sum_gap():
        diff = (port - pallas).abs()
        bound = 2.0 ** -8 * (parts.abs().sum(2) + port.abs()
                             + pallas.abs())
        assert bool((diff <= bound + 1e-30).all())
        assert float(diff.max() / port.abs().max()) < 1e-2


# (dtype, head dim, (batch, seq, head) strides, addresses, route of the
# forward, dQ and dK/dV) — the rule the C entries apply (tc::route in
# csrc/flash_tc.cuh)
_TC = {"fwd": "tc", "dq": "tc", "dkv": "tc"}
_SIMT = {"fwd": "simt", "dq": "simt", "dkv": "simt"}
_F32 = {"fwd": "tf32x3", "dq": "simt", "dkv": "simt"}
_F16 = {"fwd": "tc", "dq": "simt", "dkv": "simt"}
_ROUTES = {
    "bf16_d128": (torch.bfloat16, 128, (1024 * 32 * 128, 32 * 128, 128),
                  (0, 4096), _TC),
    "fp16_d64": (torch.float16, 64, (128 * 12 * 64, 12 * 64, 64), (16,),
                 _F16),
    "bf16_d8": (torch.bfloat16, 8, (64, 16, 8), (32,), _TC),
    "bf16_d256": (torch.bfloat16, 256, (256 * 2, 256 * 2, 256), (0,), _TC),
    "fused_qkv_view": (torch.bfloat16, 64, (130 * 3 * 4 * 64, 3 * 4 * 64,
                                            64), (0, 512, 1024), _TC),
    "f32": (torch.float32, 128, (2 * 128, 2 * 128, 128), (0,), _F32),
    "bf16_d30": (torch.bfloat16, 30, (60, 60, 30), (0,), _SIMT),
    "bf16_d264": (torch.bfloat16, 264, (528, 528, 264), (0,), _SIMT),
    "row_stride_off_8": (torch.bfloat16, 64, (4 * 65 * 9, 4 * 65, 65),
                         (0,), _SIMT),
    "address_off_16": (torch.bfloat16, 64, (64, 64, 64), (0, 2), _SIMT),
    "fp16_d264": (torch.float16, 264, (528, 528, 264), (0,), _SIMT),
    "f32_fused_qkv_view": (torch.float32, 64, (130 * 3 * 4 * 64,
                                               3 * 4 * 64, 64),
                           (0, 1024, 2048), _F32),
    "f32_d30": (torch.float32, 30, (60, 60, 30), (0,), _SIMT),
    "f32_d264": (torch.float32, 264, (528, 528, 264), (0,), _SIMT),
    "f32_stride_off_4": (torch.float32, 64, (4 * 66, 66, 66), (0,), _SIMT),
    "f32_address_off_16": (torch.float32, 64, (256, 256, 64), (0, 8),
                           _SIMT),
}


@pytest.mark.parametrize("name", sorted(_ROUTES))
def test_flash_route_rule(name):
    """The route of each kernel's launch: 16-bit tensor cores for bf16
    (forward, dQ and dK/dV) and fp16 (the forward only: dS does not fit
    fp16 once split), 3xTF32 tensor cores for an f32 forward, each with a
    head dim that is a multiple of 8 up to 256 and 16-byte aligned rows;
    the CUDA-core kernels for everything else."""
    dtype, d, strides, addrs, routes = _ROUTES[name]
    assert {k: tfa.flash_route(k, dtype, d, strides, addrs)
            for k in tfa.FLASH_KERNELS} == routes


def test_flash_route_of_checked_operands():
    """``_route_of`` reads the dtype, strides and addresses of the
    operands the wrappers launch on: a contiguous bf16 layout takes tc for
    every kernel, a view whose rows start 2 bytes off takes simt; f32
    takes tf32x3 for the forward and simt for the backward; fp16 takes tc
    for the forward and simt for dQ and dK/dV."""
    x = torch.zeros(2, 10, 4, 72, dtype=torch.bfloat16)
    for kernel in tfa.FLASH_KERNELS:
        assert tfa._route_of(kernel, [x[..., :64], x[..., 8:]]) == "tc"
        assert tfa._route_of(kernel, [x[..., 1:65]]) == "simt"
    assert tfa._route_of("fwd", [x.float()]) == "tf32x3"
    assert tfa._route_of("fwd", [x.float()[..., 2:66]]) == "simt"
    assert tfa._route_of("fwd", [x.half()]) == "tc"
    for kernel in ("dq", "dkv"):
        assert tfa._route_of(kernel, [x.float()]) == "simt"
        assert tfa._route_of(kernel, [x.half()]) == "simt"
    with pytest.raises(ValueError):
        tfa.flash_route("dk", torch.bfloat16, 64, (), ())


# head dim -> the kernel a tc-route launch runs (tc::wgmma in
# csrc/flash_tc.cuh: the wgmma kernels at tile head dims up to 128)
_FWD_TC_KERNELS = {8: "wgmma", 32: "wgmma", 40: "wgmma", 64: "wgmma",
                   72: "wgmma", 80: "wgmma", 128: "wgmma", 136: "mma_sync",
                   192: "mma_sync", 256: "mma_sync"}


@pytest.mark.parametrize("d", sorted(_FWD_TC_KERNELS))
def test_flash_fwd_tc_kernel_rule(d):
    """The tc route's forward runs the wgmma kernel at head dims up to
    WGMMA_MAX_HEAD_DIM and the mma.sync kernel above; the rule only
    speaks of head dims a route takes."""
    assert tfa.flash_fwd_tc_kernel(d) == _FWD_TC_KERNELS[d]
    assert (d <= tfa.WGMMA_MAX_HEAD_DIM) == (_FWD_TC_KERNELS[d]
                                             == "wgmma")
    assert tfa.flash_route("fwd", torch.bfloat16, d,
                           (64 * d, 4 * d, d), (0,)) == "tc"


@pytest.mark.parametrize("d", [0, 264, -8])
def test_flash_fwd_tc_kernel_refuses_head_dims_off_the_route(d):
    with pytest.raises(ValueError):
        tfa.flash_fwd_tc_kernel(d)


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("d", sorted(_FWD_TC_KERNELS))
def test_flash_tc_kernel_is_one_rule_for_the_three_kernels(kernel, d):
    """The forward, dQ and dK/dV on the tc route follow one rule
    (``tc::wgmma``): the wgmma kernels at head dims up to
    WGMMA_MAX_HEAD_DIM, the mma.sync kernels above; the forward's name
    for it agrees, and bf16 takes the tc route for all three."""
    assert tfa.flash_tc_kernel(kernel, d) == _FWD_TC_KERNELS[d]
    assert tfa.flash_tc_kernel(kernel, d) == tfa.flash_fwd_tc_kernel(d)
    assert tfa.flash_route(kernel, torch.bfloat16, d,
                           (64 * d, 4 * d, d), (0,)) == "tc"


@pytest.mark.parametrize("kernel, d", [("dk", 64), ("dq", 0), ("dkv", 264),
                                       ("fwd", -8)])
def test_flash_tc_kernel_refuses_kernels_and_head_dims_off_the_route(
        kernel, d):
    with pytest.raises(ValueError):
        tfa.flash_tc_kernel(kernel, d)


def test_flash_bwd_counts_no_wgmma_launch_on_the_cpu():
    """On CPU tensors the backward runs the plain version: neither the tc
    counters of dQ and dK/dV nor their wgmma kernels' count a launch."""
    x = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    out, lse = tfa.flash_fwd(x, x, x, True, 0.125, want_lse=True)
    names = ["bwd_plain"] + [f"{k}_cuda_tc{w}" for k in ("dq", "dkv")
                             for w in ("", "_wgmma")]
    before = {n: monitor.counter(f"kernels.flash.{n}").get() for n in names}
    tfa.flash_bwd(x, x, x, out, lse, x, True, 0.125)
    after = {n: monitor.counter(f"kernels.flash.{n}").get() for n in names}
    assert after == dict(before, bwd_plain=before["bwd_plain"] + 1)


def test_flash_fwd_counts_no_wgmma_launch_on_the_cpu():
    """On CPU tensors the forward runs the plain version: neither the tc
    counter nor the wgmma kernel's counts a launch."""
    x = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    before = {n: monitor.counter(f"kernels.flash.{n}").get()
              for n in ("fwd_plain", "fwd_cuda_tc", "fwd_cuda_tc_wgmma")}
    tfa.flash_fwd(x, x, x, True, 0.125)
    after = {n: monitor.counter(f"kernels.flash.{n}").get() for n in before}
    assert after == dict(before, fwd_plain=before["fwd_plain"] + 1)


def test_flash_bwd_kernels_use_no_atomics():
    """dK/dV sums a GQA group inside one block and writes once, and dQ
    needs no group sum: no kernel of csrc/flash_bwd.cu (nor the headers
    it includes) adds into memory, so the backward is deterministic."""
    import pathlib
    import re
    csrc = pathlib.Path(tfa.__file__).parents[1] / "csrc"
    for name in ("flash_bwd.cu", "flash_tc.cuh", "flash_common.cuh",
                 "grouped_gemm_tc.cuh", "common.cuh"):
        src = (csrc / name).read_text()
        assert not re.search(r"atomic[A-Z]|\bred\.|\batom\.", src), name


def test_fwd_launched_kernels_follow_the_c_entry():
    """``_LAUNCHED`` reads the kernel id that ``flash_fwd_launch`` and the
    two backward entries report in the order of the C enum ``Launched``
    (csrc/flash_tc.cuh), and holds every (route, tc kernel) pair the rule
    can name: all four for the forward, simt, mma.sync and wgmma for dQ
    and dK/dV. Each entry takes the report as its last argument (a
    pointer in ``_build.SIGNATURES``) and writes it."""
    import pathlib
    import re

    from paddle_tpu_torch.kernels import _build
    csrc = pathlib.Path(tfa.__file__).parents[1] / "csrc"
    src = (csrc / "flash_tc.cuh").read_text()
    enum = re.search(r"enum Launched \{([^}]*)\}", src).group(1)
    ids = dict((n, int(i)) for n, i in
               re.findall(r"kLaunched(\w+) = (\d+)", enum))
    assert ids == {"Simt": 0, "Tf32x3": 1, "Mma": 2, "Wgmma": 3}
    assert tfa._LAUNCHED == (("simt", None), ("tf32x3", None),
                             ("tc", "mma_sync"), ("tc", "wgmma"))
    named = {k: set() for k in tfa.FLASH_KERNELS}
    for kernel in tfa.FLASH_KERNELS:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for d in (8, 60, 64, 96, 128, 136, 256):
                route = tfa.flash_route(kernel, dtype, d,
                                        (64 * d, 4 * d, d), (0,))
                named[kernel].add((route, tfa.flash_tc_kernel(kernel, d)
                                   if route == "tc" else None))
    assert named["fwd"] == set(tfa._LAUNCHED)
    assert named["dq"] == named["dkv"] == {tfa._LAUNCHED[i]
                                           for i in (0, 2, 3)}
    bwd = (csrc / "flash_bwd.cu").read_text()
    assert "float scale, int dtype, void *stream, int *kernel" in bwd
    for entry in ("dq", "dkv"):
        body = re.search(rf"flash_bwd_{entry}_launch\(FLASH_BWD_PARAMS\) "
                         r"\{(.*?)\n\}", bwd, re.S).group(1)
        assert "dtype, stream, kernel);" in body
    fwd = (csrc / "flash_fwd.cu").read_text()
    assert "float scale, int dtype, void* stream, int* kernel)" in fwd
    for lib, entry in (("flash_fwd", "flash_fwd_launch"),
                       ("flash_bwd", "flash_bwd_dq_launch"),
                       ("flash_bwd", "flash_bwd_dkv_launch")):
        assert _build.SIGNATURES[lib][entry][-2:] == [ctypes.c_void_p] * 2
