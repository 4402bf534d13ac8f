"""The arithmetic of the tensor-core ("tc") flash kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), emulated in plain PyTorch
on the CPU and held to ``flash_plain`` / ``flash_bwd_plain`` (f32 math on
the same bf16 inputs) under chip_smoke.py's element-wise gate.

The kernels take the products whose operands are inputs (S = Q K^T,
dP = dO V^T) from the bf16 inputs exactly, with f32 accumulators; the
products whose left operand the kernel computes (P V, P^T dO, dS^T Q)
take it as two bf16 terms, hi + lo, into one f32 accumulator. The tests
show that this split passes the gate (ratio <= 1) and that rounding P
and dS to bf16 once, as FlashAttention-2/3 do, fails it several times
over: the control that the gate is sharp enough to tell the two apart.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa

LOG2E = 1.4426950408889634
#: query rows per dK/dV tile (``DkvTc``)
BQ = 32
#: a single bf16 rounding of P must fail the gate by more than this
SHARP = 4.0


def gate_ratio(got, ref):
    """chip_smoke.py's ``closeness`` rule for a 16-bit output, copied:
    |got - ref| <= eps(dtype) |ref| + 1e-3 rms(ref); the worst ratio of
    the error to its allowance (pass: <= 1)."""
    rtol = torch.finfo(got.dtype).eps
    got, ref = got.float(), ref.float()
    atol = max(1e-3 * float(ref.square().mean().sqrt()), 1e-30)
    return float(((got - ref).abs() / (rtol * ref.abs() + atol)).max())


def _terms(x, split):
    """The 16-bit terms of the f32 operand x that a kernel feeds its
    second product: hi and lo with the split, one rounding without."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()] if split else [hi]


def _repeat_kv(x, h):
    return x.float().repeat_interleave(h // x.shape[1], dim=1)


def tc_forward(q, k, v, scale, keep, split):
    """The forward kernel's tile arithmetic on q [B, H, Sq, D], k/v
    [B, Hkv, Sk, D] (bf16): per key tile (``FwdTc::kBK``: 64 keys at head
    dim <= 64, else 32), S in f32, the running max in units of scale
    log2e, exp2, l summed from the unsplit P, O += each term of P times V;
    the output rounded to bf16 once."""
    h = q.shape[1]
    qf, kf, vf = q.float(), _repeat_kv(k, h), _repeat_kv(v, h)
    sl2 = scale * LOG2E
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


def tc_dkv(q, k, v, o, lse, do, scale, keep, split):
    """The dK/dV kernel's tile arithmetic: per q tile of BQ rows,
    P = exp2(scale log2e S - log2e lse) (0 where masked or for a row
    without keys), dS = P (dP - Delta), dV += each term of P^T times dO,
    dK += each term of dS^T times Q, dK times scale at the end; a GQA
    group summed in f32; both rounded to bf16 once."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf, of, dof = q.float(), o.float(), do.float()
    kf, vf = _repeat_kv(k, h), _repeat_kv(v, h)
    delta = (dof * of).sum(-1, keepdim=True)
    lse2 = torch.where(lse > fa.ROW_INVALID_LSE, lse * LOG2E,
                       torch.inf)[..., None]
    dk = torch.zeros(b, h, sk, d)
    dv = torch.zeros(b, h, sk, d)
    for q0 in range(0, sq, BQ):
        rows = slice(q0, q0 + BQ)
        s = qf[:, :, rows] @ kf.transpose(-1, -2)
        dp = dof[:, :, rows] @ vf.transpose(-1, -2)
        p = torch.exp2(s * (scale * LOG2E) - lse2[:, :, rows])
        if keep is not None:
            p = torch.where(keep[..., rows, :], p, 0.0)
        ds = p * (dp - delta[:, :, rows])
        for term in _terms(p, split):
            dv = dv + term.transpose(-1, -2) @ dof[:, :, rows]
        for term in _terms(ds, split):
            dk = dk + term.transpose(-1, -2) @ qf[:, :, rows]
    dk = (dk * scale).reshape(b, hkv, h // hkv, sk, d).sum(2)
    dv = dv.reshape(b, hkv, h // hkv, sk, d).sum(2)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


# name: (B, S, H, Hkv, D, document lengths or None); all causal
CASES = {"causal_d128": (1, 512, 2, 2, 128, None),
         "gqa_docmask_d64": (1, 512, 8, 2, 64, [256, 128, 128])}


def _inputs(name):
    B, S, H, Hkv, D, docs = CASES[name]
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


@pytest.mark.parametrize("name", sorted(CASES))
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
