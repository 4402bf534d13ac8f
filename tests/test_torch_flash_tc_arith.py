"""The arithmetic of the tensor-core flash kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``), emulated in plain PyTorch on the CPU and held to
``flash_plain`` / ``flash_bwd_plain`` (f32 math on the same inputs) under
chip_smoke.py's element-wise gate.

The "tc" kernels take the products whose operands are inputs (S = Q K^T,
dP = dO V^T) from the bf16 inputs exactly, with f32 accumulators; the
products whose left operand the kernel computes (P V, dS K, P^T dO,
dS^T Q) take it as two bf16 terms, hi + lo, into one f32 accumulator.
The tests show that this split passes the gate (ratio <= 1) and that
rounding P and dS to bf16 once, as FlashAttention-2/3 do, fails it
several times over: the control that the gate is sharp enough to tell the
two apart. In fp16 the same split of dS loses bits or overflows where
the reference keeps f32, which is why the backward kernels take the tc
route for bf16 only.

The "tf32x3" forward takes every product of f32 operands as big big +
big small + small big of their TF32 terms (big = tf32(x), small =
tf32(x - big)); it passes the f32 gate, one TF32 product fails it, and on
the head-dim-64 probe's integer tile it is exact.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa

LOG2E = 1.4426950408889634
#: query rows per dK/dV tile (``DkvTc``)
BQ = 32
#: keys per tile of the tf32x3 forward (``FwdTf32``)
BK_TF32 = 32
#: a single bf16 rounding of P must fail the gate by more than this
SHARP = 4.0


def gate_ratio(got, ref, atol_floor=0.0):
    """chip_smoke.py's ``closeness`` rule, copied: |got - ref| <= rtol
    |ref| + atol, for a 16-bit output rtol eps(dtype) and atol 1e-3
    rms(ref), for an f32 one rtol 0 and atol 1e-4 max(1, max |ref|); the
    worst ratio of the error to its allowance (pass: <= 1; inf when got
    is not finite). ``atol_floor`` raises atol to at least that value."""
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    half = got.dtype != torch.float32
    rtol = torch.finfo(got.dtype).eps if half else 0.0
    got, ref = got.float(), ref.float()
    atol = 1e-3 * float(ref.square().mean().sqrt()) if half else \
        1e-4 * max(1.0, float(ref.abs().max()))
    atol = max(atol, atol_floor, 1e-30)
    return float(((got - ref).abs() / (rtol * ref.abs() + atol)).max())


def _terms(x, split, dtype=torch.bfloat16):
    """The 16-bit terms of the f32 operand x that a kernel feeds its
    second product: hi and lo with the split, one rounding without."""
    hi = x.to(dtype).float()
    return [hi, (x - hi).to(dtype).float()] if split else [hi]


def _repeat_kv(x, h):
    return x.float().repeat_interleave(h // x.shape[1], dim=1)


def tc_forward(q, k, v, scale, keep, split, bk=None):
    """The forward kernel's tile arithmetic on q [B, H, Sq, D], k/v
    [B, Hkv, Sk, D] (bf16): per key tile (``bk`` keys; by default the
    mma.sync kernel's ``FwdTc::kBK``: 64 at head dim <= 64, else 32), S in
    f32, the running max in units of scale log2e, exp2, l summed from the
    unsplit P, O += each term of P times V; the output rounded to bf16
    once."""
    h = q.shape[1]
    qf, kf, vf = q.float(), _repeat_kv(k, h), _repeat_kv(v, h)
    sl2 = scale * LOG2E
    if bk is None:
        bk = 64 if q.shape[-1] <= 64 else 32
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape)
    for k0 in range(0, kf.shape[2], bk):
        s = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        if keep is not None:
            s = torch.where(keep[..., k0:k0 + bk], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        base = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s * sl2 - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for term in _terms(p, split):
            acc = acc + term @ vf[:, :, k0:k0 + bk]
        m = m_new
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    return out.to(torch.bfloat16)


def tc_dkv(q, k, v, o, lse, do, scale, keep, split, dtype=torch.bfloat16,
           bq=BQ):
    """The dK/dV kernel's tile arithmetic: per q tile of ``bq`` rows
    (``DkvTc::kBQ`` by default; the wgmma kernel's ``DkvCfg::kBQ``),
    P = exp2(scale log2e S - log2e lse) (0 where masked or for a row
    without keys), dS = P (dP - Delta), dV += each 16-bit term of P^T
    times dO, dK += each term of dS^T times Q, dK times scale at the end;
    a GQA group summed in f32; both rounded to ``dtype`` once."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf, of, dof = q.float(), o.float(), do.float()
    kf, vf = _repeat_kv(k, h), _repeat_kv(v, h)
    delta = (dof * of).sum(-1, keepdim=True)
    lse2 = torch.where(lse > fa.ROW_INVALID_LSE, lse * LOG2E,
                       torch.inf)[..., None]
    dk = torch.zeros(b, h, sk, d)
    dv = torch.zeros(b, h, sk, d)
    for q0 in range(0, sq, bq):
        rows = slice(q0, q0 + bq)
        s = qf[:, :, rows] @ kf.transpose(-1, -2)
        dp = dof[:, :, rows] @ vf.transpose(-1, -2)
        p = torch.exp2(s * (scale * LOG2E) - lse2[:, :, rows])
        if keep is not None:
            p = torch.where(keep[..., rows, :], p, 0.0)
        ds = p * (dp - delta[:, :, rows])
        for term in _terms(p, split, dtype):
            dv = dv + term.transpose(-1, -2) @ dof[:, :, rows]
        for term in _terms(ds, split, dtype):
            dk = dk + term.transpose(-1, -2) @ qf[:, :, rows]
    dk = (dk * scale).reshape(b, hkv, h // hkv, sk, d).sum(2)
    dv = dv.reshape(b, hkv, h // hkv, sk, d).sum(2)
    return dk.to(dtype), dv.to(dtype)


def tc_dq(q, k, v, o, lse, do, scale, keep, split, dtype=torch.bfloat16,
          bk=32):
    """The dQ kernel's tile arithmetic: per key tile of ``bk`` keys (32:
    ``DqCfg::kBN`` of the wgmma kernel, ``DqTc::kBK`` of the mma.sync
    one), P = exp2(scale log2e S - log2e lse) (0 where masked or for a
    row without keys), dS = P (dP - Delta), dQ += each 16-bit term of dS
    times K; dQ times scale at the end, rounded to ``dtype`` once."""
    h = q.shape[1]
    qf, of, dof = q.float(), o.float(), do.float()
    kf, vf = _repeat_kv(k, h), _repeat_kv(v, h)
    delta = (dof * of).sum(-1, keepdim=True)
    lse2 = torch.where(lse > fa.ROW_INVALID_LSE, lse * LOG2E,
                       torch.inf)[..., None]
    dq = torch.zeros(qf.shape)
    for k0 in range(0, kf.shape[2], bk):
        cols = slice(k0, k0 + bk)
        s = qf @ kf[:, :, cols].transpose(-1, -2)
        dp = dof @ vf[:, :, cols].transpose(-1, -2)
        p = torch.exp2(s * (scale * LOG2E) - lse2)
        if keep is not None:
            p = torch.where(keep[..., cols], p, 0.0)
        ds = p * (dp - delta)
        for term in _terms(ds, split, dtype):
            dq = dq + term @ kf[:, :, cols]
    return (dq * scale).to(dtype)


def tf32(x):
    """TF32 rounding as ``cvt.rna.tf32.f32`` does it: the f32 bit pattern
    rounded to 10 mantissa bits, ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32(a, b, passes):
    """a @ b on the tensor cores' TF32 products: ``passes`` 3 takes big
    big + big small + small big of the split operands (3xTF32), 1 takes
    one product of the rounded operands."""
    ab, bb = tf32(a), tf32(b)
    if passes == 1:
        return ab @ bb
    return tf32(a - ab) @ bb + ab @ tf32(b - bb) + ab @ bb


def tf32x3_forward(q, k, v, scale, keep, passes=3):
    """The tf32x3 forward's tile arithmetic (``FwdTf32``) on f32 q
    [B, H, Sq, D], k/v [B, Hkv, Sk, D]: per key tile of BK_TF32 keys S by
    ``mm_tf32``, the online softmax of the tc forward in f32, O += P V by
    ``mm_tf32``; returns (out, lse)."""
    h = q.shape[1]
    kf, vf = _repeat_kv(k, h), _repeat_kv(v, h)
    sl2 = scale * LOG2E
    bk = BK_TF32
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for k0 in range(0, kf.shape[2], bk):
        s = mm_tf32(q, kf[:, :, k0:k0 + bk].transpose(-1, -2), passes)
        if keep is not None:
            s = torch.where(keep[..., k0:k0 + bk], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        base = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s * sl2 - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm_tf32(p, vf[:, :, k0:k0 + bk], passes)
        m = m_new
    valid = l > 0
    out = torch.where(valid, acc / torch.where(valid, l, 1.0), 0.0)
    lse = torch.where(valid, (m + torch.log2(torch.where(valid, l, 1.0)))
                      / LOG2E, fa.NEG_INF)
    return out, lse[..., 0]


# name: (B, S, H, Hkv, D, document lengths or None); all causal
CASES = {"causal_d128": (1, 512, 2, 2, 128, None),
         "gqa_docmask_d64": (1, 512, 8, 2, 64, [256, 128, 128])}
#: bf16 at tile head dim 256, where the tc route's backward runs the
#: mma.sync kernels (``DqTc``, ``DkvTc``; 32-key and 32-row tiles, the
#: wgmma kernels' too)
D256_CASES = {"causal_d256": (1, 256, 2, 2, 256, None),
              "gqa_docmask_d256": (1, 256, 4, 2, 256, [128, 64, 64])}


def _inputs(name):
    B, S, H, Hkv, D, docs = {**CASES, **D256_CASES}[name]
    rng = np.random.default_rng(len(name))
    q, do = (torch.from_numpy(rng.standard_normal((B, H, S, D),
                                                  dtype=np.float32))
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, S, D),
                                                 dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2))
    se = None
    if docs is not None:
        raw = torch.zeros(1, 1, S, 1, dtype=torch.int32)
        lo = 0
        for n in docs:
            raw[:, :, lo:lo + n, 0] = lo + n      # key j masked from its
            lo += n                               # document's end on
        se = fa._normalize_startend(raw, S, S, True)
    keep = fa._keep_mask(S, S, H, True, None, se, q.device)
    return q, k, v, do, D ** -0.5, se, keep


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_split_passes_and_single_rounding_fails(name):
    q, k, v, _, scale, se, keep = _inputs(name)
    ref = fa.flash_plain(q.float(), k.float(), v.float(), True, scale,
                         se=se)
    split = gate_ratio(tc_forward(q, k, v, scale, keep, True), ref)
    single = gate_ratio(tc_forward(q, k, v, scale, keep, False), ref)
    assert split <= 1.0, split
    assert single > SHARP, single


@pytest.mark.parametrize("bk", [32, 64, 128])
@pytest.mark.parametrize("name", sorted(CASES))
def test_wgmma_forward_tiles_split_passes(name, bk):
    """The wgmma forward's key tiles (32 keys in ``Fwd64`` / ``Fwd128`` of
    csrc/flash_fwd.cu; 64 and 128, the other sizes ``fwg::Cfg`` takes)
    keep the arithmetic: the split passes the gate, one rounding of P
    fails it by more than SHARP."""
    q, k, v, _, scale, se, keep = _inputs(name)
    ref = fa.flash_plain(q.float(), k.float(), v.float(), True, scale,
                         se=se)
    split = gate_ratio(tc_forward(q, k, v, scale, keep, True, bk), ref)
    single = gate_ratio(tc_forward(q, k, v, scale, keep, False, bk), ref)
    assert split <= 1.0, split
    assert single > SHARP, single


def _acc_map(n):
    """(row, column) of f32 accumulator i of thread T of a warpgroup in
    wgmma m64n{n}k16 (PTX ISA, the D fragment; csrc/grouped_gemm_tc.cuh):
    warp w = T // 32, lane = 4 g + t; row 16 w + g + 8 ((i % 4) // 2),
    column 8 (i // 4) + 2 t + i % 2. Arrays [128 threads, n / 2]."""
    T, i = np.arange(128)[:, None], np.arange(n // 2)[None, :]
    g, t = T % 32 // 4, T % 4
    return 16 * (T // 32) + g + 8 * (i % 4 // 2), 8 * (i // 4) + 2 * t + i % 2


def _a_frag_map(n):
    """(row, k) of 16-bit half e (0 low, 1 high) of A register r of k16
    chunk c, thread T, for wgmma with A from registers (PTX ISA: each
    warp's 16 rows hold the mma.m16n8k16 A fragment): row 16 w + g +
    8 (r % 2), k 16 c + 8 (r // 2) + 2 t + e. Arrays [128, n / 16, 4, 2]."""
    T = np.arange(128)[:, None, None, None]
    c = np.arange(n // 16)[None, :, None, None]
    r, e = np.arange(4)[None, None, :, None], np.arange(2)
    g, t = T % 32 // 4, T % 4
    rows = 16 * (T // 32) + g + 8 * (r % 2) + 0 * c + 0 * e
    return rows, 16 * c + 8 * (r // 2) + 2 * t + e + 0 * rows


@pytest.mark.parametrize("n", [32, 64, 128])
def test_s_accumulators_are_the_p_fragments_in_place(n):
    """The wgmma kernels build register r of an operand's k16 chunk c from
    its accumulators 8 c + 2 r (low half) and 8 c + 2 r + 1 (high half)
    (``wg::split``, csrc/flash_tc.cuh): the row/column map of m64n{n}k16's
    accumulators then gives every element where the register-A fragment
    wants it, so S turns into P_hi and P_lo fragments in place in the
    forward (n = its key tile), and so do dS in dQ (n = kBN) and P^T and
    dS^T in dK/dV (n = kBQ; both 32 as configured). Emulated on a random
    P: the fragments rebuilt by the A map are P rounded to bf16 (hi) and
    its remainder (lo), and P_hi V + P_lo V holds the gate where one
    rounding of P misses it."""
    acc_r, acc_c = _acc_map(n)
    fr, fk = _a_frag_map(n)
    idx = (8 * np.arange(n // 16)[:, None, None] + 2 * np.arange(4)[:, None]
           + np.arange(2))                       # [chunk, reg, half]
    assert np.array_equal(acc_r[:, idx], fr)
    assert np.array_equal(acc_c[:, idx], fk)
    cells = acc_r * n + acc_c
    assert np.array_equal(np.sort(cells.ravel()), np.arange(64 * n))
    rng = np.random.default_rng(n)
    p = torch.from_numpy(rng.uniform(0, 1, (64, n)).astype(np.float32) ** 8)
    v = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32)) \
        .to(torch.bfloat16)
    regs = p[torch.from_numpy(acc_r), torch.from_numpy(acc_c)]  # [128, n/2]
    hi = regs.to(torch.bfloat16).float()
    lo = (regs - hi).to(torch.bfloat16).float()
    a_hi, a_lo = torch.zeros(64, n), torch.zeros(64, n)
    at = (torch.from_numpy(fr), torch.from_numpy(fk))
    a_hi[at] = hi[:, torch.from_numpy(idx)]
    a_lo[at] = lo[:, torch.from_numpy(idx)]
    assert torch.equal(a_hi, p.to(torch.bfloat16).float())
    assert torch.equal(a_lo, (p - a_hi).to(torch.bfloat16).float())
    ref = p @ v.float()
    split = (a_hi @ v.float() + a_lo @ v.float()).to(torch.bfloat16)
    single = (a_hi @ v.float()).to(torch.bfloat16)
    assert gate_ratio(split, ref) <= 1.0
    assert gate_ratio(single, ref) > 1.0


@pytest.mark.parametrize("name", sorted(CASES) + sorted(D256_CASES))
def test_dkv_split_passes_and_single_rounding_fails(name):
    q, k, v, do, scale, se, keep = _inputs(name)
    out, lse = fa.flash_plain(q.float(), k.float(), v.float(), True, scale,
                              se=se, return_lse=True)
    o = out.to(torch.bfloat16)
    _, rk, rv = fa.flash_bwd_plain(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), True, scale,
                                   se=se)
    ratios = {}
    for split in (True, False):
        dk, dv = tc_dkv(q, k, v, o, lse, do, scale, keep, split)
        ratios[split] = (gate_ratio(dk, rk), gate_ratio(dv, rv))
    assert max(ratios[True]) <= 1.0, ratios
    assert min(ratios[False]) > SHARP, ratios


@pytest.mark.parametrize("name", sorted(CASES) + sorted(D256_CASES))
def test_dq_split_passes_and_single_rounding_fails(name):
    """The dQ kernel's split of dS into bf16 hi + lo passes the gate; one
    bf16 rounding of dS fails it by more than SHARP."""
    q, k, v, do, scale, se, keep = _inputs(name)
    out, lse = fa.flash_plain(q.float(), k.float(), v.float(), True, scale,
                              se=se, return_lse=True)
    o = out.to(torch.bfloat16)
    rq = fa.flash_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                            do.float(), True, scale, se=se)[0]
    split = gate_ratio(tc_dq(q, k, v, o, lse, do, scale, keep, True), rq)
    single = gate_ratio(tc_dq(q, k, v, o, lse, do, scale, keep, False), rq)
    assert split <= 1.0, split
    assert single > SHARP, single


#: keys per tile of the wgmma dQ kernel (``DqCfg::kBN``, csrc/flash_bwd.cu)
WGMMA_DQ_BN = 32
#: q rows per item of the wgmma dK/dV kernel (``DkvCfg::kBQ``)
WGMMA_DKV_BQ = 32


@pytest.mark.parametrize("name", sorted(CASES))
def test_wgmma_dq_tiles_split_passes(name):
    """The wgmma dQ kernel's key tiles keep the arithmetic: dQ += dS_hi K
    + dS_lo K per tile of ``WGMMA_DQ_BN`` keys passes the gate, one bf16
    rounding of dS fails it by more than SHARP."""
    bk = WGMMA_DQ_BN
    q, k, v, do, scale, se, keep = _inputs(name)
    out, lse = fa.flash_plain(q.float(), k.float(), v.float(), True, scale,
                              se=se, return_lse=True)
    o = out.to(torch.bfloat16)
    rq = fa.flash_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                            do.float(), True, scale, se=se)[0]
    split = gate_ratio(tc_dq(q, k, v, o, lse, do, scale, keep, True, bk=bk),
                       rq)
    single = gate_ratio(tc_dq(q, k, v, o, lse, do, scale, keep, False,
                              bk=bk), rq)
    assert split <= 1.0, split
    assert single > SHARP, single


@pytest.mark.parametrize("name", sorted(CASES))
def test_wgmma_dkv_tiles_split_passes(name):
    """The wgmma dK/dV kernel's items (``WGMMA_DKV_BQ`` q rows of one
    query head; its keys, the M dimension, are independent rows, so the
    key tile does not enter the arithmetic) keep it too: dV += P^T_hi dO
    + P^T_lo dO and dK += dS^T_hi Q + dS^T_lo Q summed over the GQA group
    in f32 pass the gate, one bf16 rounding of P^T and dS^T fails it by
    more than SHARP."""
    q, k, v, do, scale, se, keep = _inputs(name)
    out, lse = fa.flash_plain(q.float(), k.float(), v.float(), True, scale,
                              se=se, return_lse=True)
    o = out.to(torch.bfloat16)
    _, rk, rv = fa.flash_bwd_plain(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), True, scale,
                                   se=se)
    ratios = {}
    for split in (True, False):
        dk, dv = tc_dkv(q, k, v, o, lse, do, scale, keep, split,
                        bq=WGMMA_DKV_BQ)
        ratios[split] = (gate_ratio(dk, rk), gate_ratio(dv, rv))
    assert max(ratios[True]) <= 1.0, ratios
    assert min(ratios[False]) > SHARP, ratios


#: fp16's smallest subnormal step: one rounding of an f32 result to fp16
#: can be off by half of it wherever |result| < 2^-14
F16_STEP = 2.0 ** -24


@pytest.mark.parametrize("mul", [1e-4, 1e-5, 1e4])
def test_fp16_split_of_ds_fails_where_f32_ds_passes(mul):
    """fp16 backward at dO = randn x mul (causal S 512, D 128): dS kept in
    f32 and each output rounded to fp16 once (the simt kernels) stays
    within the gate, its atol floored at one fp16 subnormal step (below
    2^-14 the output format's own resolution; at x 1e-4 and x 1e-5 the
    outputs lie there); the tc kernels' split of dS into two fp16 terms
    loses bits below 2^-14 and overflows above 65504, and misses that
    gate or gives inf, for dQ and dK alike. This is why fp16 dQ and dK/dV
    are routed to simt."""
    rng = np.random.default_rng(16)
    S, D = 512, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 2, S, D), dtype=np.float32)).half() for _ in range(3))
    do = torch.from_numpy(rng.standard_normal((1, 2, S, D), dtype=np.float32)
                          * mul).half()
    scale = D ** -0.5
    out, lse = fa.flash_plain(q.float(), k.float(), v.float(), True, scale,
                              return_lse=True)
    o = out.half()
    keep = fa._keep_mask(S, S, 2, True, None, None, q.device)
    rq, rk, _ = fa.flash_bwd_plain(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), True, scale)
    assert bool(torch.isfinite(rq.half()).all() and
                torch.isfinite(rk.half()).all())
    # the simt kernels: f32 math, each output rounded to fp16 once
    simt = (gate_ratio(rq.half(), rq, F16_STEP),
            gate_ratio(rk.half(), rk, F16_STEP))
    assert max(simt) <= 1.0, simt
    dq = tc_dq(q, k, v, o, lse, do, scale, keep, True, torch.float16)
    dk = tc_dkv(q, k, v, o, lse, do, scale, keep, True, torch.float16)[0]
    split = (gate_ratio(dq, rq, F16_STEP), gate_ratio(dk, rk, F16_STEP))
    assert min(split) > 1.0, split


# name: (B, S, H, Hkv, D, causal, window, mask): "doc" a causal document
# mask, "pad" C=1 key bands of a padding mask with dead batch rows
F32_CASES = {
    "d128_causal": (1, 384, 2, 2, 128, True, None, None),
    "d128_gqa_window": (1, 384, 8, 2, 128, True, 100, None),
    "d128_docmask": (1, 384, 4, 2, 128, True, None, [128, 192, 64]),
    "d64_pad_bands_dead_rows": (4, 128, 4, 4, 64, False, None, "pad"),
}


def _f32_inputs(name):
    from paddle_tpu_torch.nn.functional import _mask_to_key_bands
    B, S, H, Hkv, D, causal, window, mask = F32_CASES[name]
    rng = np.random.default_rng(len(name) + 100)
    q = torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, S, D),
                                                 dtype=np.float32))
            for _ in range(2))
    se = None
    if mask == "pad":
        lens = torch.tensor([S, 77, 13, 0])          # the last row dead
        pad = (torch.arange(S)[None] < lens[:, None])[:, None, None]
        se = fa._normalize_startend(_mask_to_key_bands(pad, B, S, S, H), S,
                                    S, False)
    elif mask is not None:
        raw = torch.zeros(1, 1, S, 1, dtype=torch.int32)
        lo = 0
        for n in mask:
            raw[:, :, lo:lo + n, 0] = lo + n
            lo += n
        se = fa._normalize_startend(raw, S, S, True)
    keep = fa._keep_mask(S, S, H, causal, window, se, q.device)
    return q, k, v, D ** -0.5, causal, window, se, keep


@pytest.mark.parametrize("name", sorted(F32_CASES))
def test_tf32x3_forward_passes_and_one_pass_tf32_fails(name):
    """The tf32x3 forward (out and lse) within the f32 gate of
    ``flash_plain``; one TF32 product instead of three misses it."""
    q, k, v, scale, causal, window, se, keep = _f32_inputs(name)
    ref, ref_lse = fa.flash_plain(q, k, v, causal, scale, window, se,
                                  return_lse=True)
    out, lse = tf32x3_forward(q, k, v, scale, keep)
    dead = ref_lse <= fa.ROW_INVALID_LSE
    assert torch.equal(lse <= fa.ROW_INVALID_LSE, dead)
    assert not out[dead].any()
    assert gate_ratio(out, ref) <= 1.0
    live = ~dead
    assert float((lse[live] - ref_lse[live]).abs().max()) <= \
        1e-5 * max(1.0, float(ref_lse[live].abs().max()))
    one_pass, _ = tf32x3_forward(q, k, v, scale, keep, passes=1)
    assert gate_ratio(one_pass, ref) > 1.0


def test_probe_tile_is_exact_through_tf32x3():
    """The head-dim-64 probe runs the tf32x3 route's tiles on its integer
    input: every entry of x x^T (|s| <= 576 < 2^11) is a TF32 number, so
    every small term is 0, and every sum stays below 2^24: (x x^T) x
    through 3xTF32, key tile by key tile, equals the plain product bit for
    bit."""
    x = fa.minor64_input("cpu")
    s = mm_tf32(x, x.T, 3)
    assert torch.equal(tf32(s), s) and torch.equal(tf32(x), x)
    assert float(s.abs().max()) <= 576
    o = torch.zeros_like(x)
    for k0 in range(0, x.shape[0], BK_TF32):
        o = o + mm_tf32(s[:, k0:k0 + BK_TF32], x[k0:k0 + BK_TF32], 3)
    assert float(o.abs().max()) < 2 ** 24
    assert torch.equal(o, fa.minor64_probe_plain(x))
