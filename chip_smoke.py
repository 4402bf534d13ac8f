#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Every phase is fatal (any failure exits non-zero and prints no result):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every csrc/*.cu compiled by nvcc for sm_90a into build/, one
   nvcc process per source, all in parallel; each library's probe kernel
   runs when it is loaded;
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it plus a few more, within a
   stated tolerance, timed with CUDA events beside the plain version,
   one library call where PyTorch has one, and the bound (the least time
   the card could take: bytes over 3.35 TB/s or operations over the
   dtype's peak, whichever is larger);
4. + 5. the main path, with every launch count set to 0 just before it
   and read just after: the no-cache LlamaForCausalLM forward at the
   full width of the repo's serving benchmark (vocab 32000, hidden 4096,
   ff 11008, 32 heads, 4 layers, f32 weights drawn from a seed), batch
   2 x seq 1024 — then an Engine serving 24 requests (prompts 64-191
   tokens, 128 new tokens each, mostly greedy, a few sampled) with 16
   slots, 128-token pages, a 64-token prefill bucket and a bf16 pool;
6. checks: finite logits of the right shape, 4 flash launches in the
   forward, every request finished, paged-decode launches == decode
   ticks x 4 layers, no leaked pages, and a cross-check of two greedy
   requests against teacher-forced argmax of the no-cache forward
   (bf16 pool and an f32 pool).

7. training kernels: the flash forward with logsumexp and the two
   backward kernels (dQ, dK/dV) against their plain versions at the
   attention shape of one layer of the training benchmark under bf16 AMP
   (B 12, S 1024, H 32, D 128, causal) plus f32, GQA (8 kv heads),
   window 256, sq 333 / sk 1024 and a 4-document flashmask, timed beside
   the plain versions, their bounds and, where aten takes the case, the
   timed-only aten flash backward;
8. model cross-check: a 2-layer, hidden-512 LLaMA (8 heads, 2 kv heads,
   window 64, seq 256, f32) — one TrainStep loss and every parameter
   gradient on the card against the same weights on the CPU, then again
   with a document mask;
9. + 10. the training main path, counts set to 0 just before it and read
   just after: ``bench.py::bench_llama_1b``'s configuration (LLaMA-7B
   widths at 4 layers, ~1.07 B parameters, batch 12 x seq 1024, fused
   4-chunk LM loss, random f32 weights from a seed) under
   TrainStep(amp_dtype="bfloat16") with AdamW(3e-4, bf16 moments) for 6
   steps on one fixed batch: finite, falling losses; flash forward, dQ
   and dK/dV launches == 4 layers x 6 steps each, the *_cuda counters
   equal to them and no *_plain call; ms per step, tokens/s, the share
   of the bf16 peak and the peak device memory.

It prints the card line, a {"kernels": [...]} line, and as its last
line {"ok": true, "device": {...}}. Details land in
chiprun_out/chip_smoke/ (result JSON, nvcc/ptxas logs). About two
minutes of command time on an H100, the three kernel builds included.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

# the serving and training configurations are those of
# paddle_tpu_torch.profile_serving / profile_training (imported in main)
N_REQUESTS, PROMPT_LO, PROMPT_HI, NEW_TOKENS = 24, 64, 192, 128
#: cross-check thresholds: share of greedy tokens equal to the
#: teacher-forced argmax of the no-cache f32 forward (an f32 pool only
#: differs by summation order; a bf16 pool rounds K/V to 8 bits)
AGREE_F32, AGREE_BF16 = 0.97, 0.85

TRAIN_STEPS = 6
#: the small on-card cross-check model
XCHECK_MODEL = dict(vocab_size=32000, hidden_size=512,
                    intermediate_size=1408, num_hidden_layers=2,
                    num_attention_heads=8, num_key_value_heads=2,
                    max_position_embeddings=256, fused_linear_ce=True,
                    fused_ce_chunks=4)
#: max relative gradient error, card vs CPU, f32 with TF32 off: only the
#: order of summation differs (kernels, cuBLAS and the CPU); TF32's 10-bit
#: mantissa would be well above it
XCHECK_GRAD_TOL, XCHECK_LOSS_TOL = 1e-4, 1e-4


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device ms of fn() over `iters` back-to-back calls (CUDA
    events around the whole run, after `warmup` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def closeness(got, ref, rtol=None, atol=None):
    """A kernel's output against its plain version (f32 math on the same
    inputs), element by element: |got - ref| <= rtol * |ref| + atol.

    By the output's dtype, unless given: f32 differs only by the order of
    summation, so rtol 0 and atol 1e-4 of max(1, max |ref|). A bf16 (or
    fp16) output is computed in f32 and rounded once on store, at most
    half an ulp, which is 2^-8 |ref| (2^-11) at the bottom of a binade:
    rtol is one ulp there, the dtype's eps, 2^-7 (2^-10), and atol 1e-3
    of the rms of ref, for the f32 noise on entries near zero. Returns
    max_abs_err, the tolerance and ``ratio``, the largest |got - ref| over
    its allowance (pass: <= 1)."""
    import torch
    half = got.dtype in (torch.bfloat16, torch.float16)
    if rtol is None:
        rtol = torch.finfo(got.dtype).eps if half else 0.0
    got, ref = got.float(), ref.float()
    if atol is None:
        atol = (1e-3 * float(ref.square().mean().sqrt()) if half
                else 1e-4 * max(1.0, float(ref.abs().max())))
    diff = (got - ref).abs()
    ratio = float((diff / (rtol * ref.abs() + max(atol, 1e-30))).max())
    return dict(max_abs_err=float(diff.max()), tol=dict(rtol=rtol, atol=atol),
                ratio=ratio)


# -- phase 3: kernels against their plain versions -------------------------

def check_paged(torch, pa, kvq):
    """Paged decode at the serving shape (16 slots, h = h_kv = 32, d 128,
    page 128, contexts ragged up to 320 with dead slots) for f32, bf16
    and int8 pools, plus a GQA (rep 4) and a window case."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, d, bs, nblk = 16, 128, 128, 3
    ctx = torch.randint(1, 321, (b,), generator=g, device=dev)
    ctx[3] = 0
    ctx[11] = 0                        # dead (idle) slots
    ctx[0], ctx[5], ctx[7] = 320, 128, 1
    nb = b * nblk + 1
    bt = (torch.randperm(nb - 1, generator=g, device=dev) + 1).reshape(
        b, nblk).to(torch.int32)
    cases = []
    specs = [("serving_bf16", 32, 32, torch.bfloat16, None),
             ("serving_f32", 32, 32, torch.float32, None),
             ("int8", 32, 32, torch.int8, None),
             ("gqa_rep4", 32, 8, torch.bfloat16, None),
             ("window", 32, 32, torch.bfloat16, 100)]
    for name, h, hkv, dt, window in specs:
        q = torch.randn(b, h, d, generator=g, device=dev)
        kf = torch.randn(nb, hkv, bs, d, generator=g, device=dev)
        vf = torch.randn(nb, hkv, bs, d, generator=g, device=dev)
        ks = vs = None
        if dt == torch.int8:
            kc, ks = kvq(kf)
            vc, vs = kvq(vf)
        else:
            kc, vc = kf.to(dt), vf.to(dt)
        args = (q, kc, vc, bt, ctx)
        kw = dict(window=window, k_scale=ks, v_scale=vs)
        got = pa.paged_decode(*args, **kw)
        torch.cuda.synchronize()
        want = pa.paged_attention_arrays(*args, **kw)
        c = closeness(got, want)
        live = (torch.minimum(ctx, torch.tensor(nblk * bs, device=dev))
                - (torch.clamp(ctx - window, min=0) if window else 0)
                ).clamp(min=0)
        toks = int(live.sum())
        item = kc.element_size()
        nbytes = (2 * toks * hkv * d * item + (8 * toks * hkv if ks is
                                               not None else 0)
                  + 2 * q.numel() * 4 + bt.numel() * 4 + ctx.numel() * 8)
        flops = 4 * toks * h * d
        bms, by = bound_ms(nbytes, flops, "float32")
        rec = dict(case=name, heads=h, kv_heads=hkv,
                   pool=str(dt).replace("torch.", ""), window=window, **c,
                   ms=cuda_ms(lambda: pa.paged_decode(*args, **kw)),
                   plain_ms=cuda_ms(lambda: pa.paged_attention_arrays(
                       *args, **kw)),
                   bound_ms=bms, bound_by=by, live_tokens=toks)
        print(f"  paged_decode[{name}]: err {c['max_abs_err']:.3g} (tol "
              f"{c['tol']}, ratio {c['ratio']:.3g}) kernel {rec['ms']:.4f} "
              f"ms, plain {rec['plain_ms']:.4f} ms, bound {bms:.4f} ms "
              f"({by})", flush=True)
        if not c["ratio"] <= 1.0:
            fail(f"paged_decode[{name}] disagrees with its plain version: "
                 f"{c}")
        cases.append(rec)
    return cases


def check_flash(torch, fa):
    """Flash forward at B 2, S 1024, H 32, D 128 causal f32 (the no-cache
    forward's shape), plus GQA, sq != sk with a window, and bf16."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    specs = [("main_f32", 2, 1024, 1024, 32, 32, 128, torch.float32, None),
             ("gqa_f32", 2, 1024, 1024, 32, 8, 128, torch.float32, None),
             ("sq_ne_sk_window", 2, 333, 1024, 32, 32, 128, torch.float32,
              256),
             ("ragged_d80", 1, 100, 77, 4, 2, 80, torch.float32, None),
             ("main_bf16", 2, 1024, 1024, 32, 32, 128, torch.bfloat16,
              None)]
    cases = []
    for name, B, sq, sk, h, hkv, d, dt, window in specs:
        q = torch.randn(B, sq, h, d, generator=g, device=dev).to(dt)
        k = torch.randn(B, sk, hkv, d, generator=g, device=dev).to(dt)
        v = torch.randn(B, sk, hkv, d, generator=g, device=dev).to(dt)
        scale = d ** -0.5
        got = fa.flash_fwd(q, k, v, True, scale, window)
        torch.cuda.synchronize()

        def plain():
            # the kernel's own arithmetic: f32 throughout
            return fa.flash_plain(q.transpose(1, 2).float(),
                                  k.transpose(1, 2).float(),
                                  v.transpose(1, 2).float(), True, scale,
                                  window).transpose(1, 2)
        c = closeness(got, plain())
        off = sk - sq
        rows = torch.arange(sq)
        hi = torch.clamp(rows + off + 1, 0, sk)
        lo = torch.clamp(rows + off - window + 1, min=0) if window else 0
        pairs = int((hi - lo).clamp(min=0).sum())
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * B * h * pairs * d
        bms, by = bound_ms(nbytes, flops, str(dt).replace("torch.", ""))
        rec = dict(case=name, B=B, sq=sq, sk=sk, heads=h, kv_heads=hkv,
                   head_dim=d, dtype=str(dt).replace("torch.", ""),
                   window=window, **c,
                   ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, True, scale,
                                                   window), iters=10),
                   plain_ms=cuda_ms(plain, iters=5),
                   bound_ms=bms, bound_by=by, library_ms=None)
        if name == "main_f32":
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            rec["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True),
                iters=10)
        print(f"  flash_fwd[{name}]: err {c['max_abs_err']:.3g} (tol "
              f"{c['tol']}, ratio {c['ratio']:.3g}) kernel {rec['ms']:.4f} "
              f"ms, plain {rec['plain_ms']:.4f} ms, library "
              f"{rec['library_ms']}, bound {bms:.4f} ms ({by})", flush=True)
        if not c["ratio"] <= 1.0:
            fail(f"flash_fwd[{name}] disagrees with its plain version: {c}")
        cases.append(rec)
    return cases


def check_probe(torch, build):
    """Each library's probe (o = x + x) against x + x, timed as raw
    launches (not counted: these are comparison launches)."""
    dev = torch.device("cuda")
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    o = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    lib = build.load("paged_decode")

    def launch():
        build.check(lib.paged_decode_probe(x.data_ptr(), o.data_ptr(),
                                           x.numel(), stream), "probe")
    launch()
    torch.cuda.synchronize()
    err = max_err(o, x + x)
    if err != 0.0:
        fail(f"probe kernel returned a wrong answer (err {err})")
    bms, by = bound_ms(2 * x.numel() * 4, x.numel(), "float32")
    plain = cuda_ms(lambda: x + x)
    return [dict(case="8x128_f32", max_abs_err=err, tol=0.0, ratio=0.0,
                 ms=cuda_ms(launch), plain_ms=plain, library_ms=plain,
                 bound_ms=bms, bound_by=by)]


def check_is_sharp(torch, fa, q, k, v, out, lse, do, scale, dv, ref_dv):
    """Negative controls at the main training shape (causal, sq == sk): a
    dK/dV kernel that leaves out one 32-row q tile, either the last (its
    q-tile loop one short) or one in the middle (a tile wrongly skipped),
    misses that tile's share of dV. Subtract the share (flash_bwd_plain
    over those rows and the keys up to their end: with sq < sk the rows
    sit bottom-right, where they sit in the full causal band) from the
    kernel's dV and show that the element-wise check rejects each. The
    rule it replaced (max abs error within 1e-2 of max |ref|) is reported
    beside it."""
    def t(x):
        return x.transpose(1, 2).float()
    old_tol = 1e-2 * max(1.0, float(ref_dv.abs().max()))
    recs = {}
    for label, lo in (("last_q_tile", q.shape[1] - 32), ("q_tile_480", 480)):
        hi = lo + 32
        share = fa.flash_bwd_plain(
            t(q[:, lo:hi]), t(k[:, :hi]), t(v[:, :hi]), t(out[:, lo:hi]),
            lse[:, :, lo:hi].contiguous(), t(do[:, lo:hi]), True, scale)[2]
        short = dv.float()
        short[:, :hi] -= share.transpose(1, 2)
        c = closeness(short.to(dv.dtype), ref_dv)
        recs[label] = rec = dict(ratio=c["ratio"],
                                 max_abs_err=c["max_abs_err"],
                                 old_rule_tol=old_tol,
                                 old_rule_passes=c["max_abs_err"] <= old_tol)
        print(f"  negative control (dV without {label}): ratio to tol "
              f"{c['ratio']:.3g} (rejected: > 1); max abs err "
              f"{c['max_abs_err']:.3g}, old rule tol {old_tol:.3g} (passes "
              f"the old rule: {rec['old_rule_passes']})", flush=True)
        if not c["ratio"] > 1.0:
            fail(f"the element-wise check does not reject dV without "
                 f"{label}: {rec}")
    return recs


def check_flash_train(torch, fa, doc_mask):
    """Phase 7: the flash forward with logsumexp, the dQ kernel and the
    dK/dV kernel against flash_plain / flash_bwd_plain (f32 math on the
    same rounded inputs) at the training shape and five edge cases. Each
    kernel is timed on its own; the bound of a kernel counts the
    operations of its own function (forward 4, dQ 6, dK/dV 8 x pairs x
    d, since each backward kernel recomputes S and dP), the pass bound
    counts the backward pass once (10 = 2.5 x the forward's)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    specs = [  # name, B, sq, sk, h, hkv, d, dtype, window, documents
        ("train_bf16", 12, 1024, 1024, 32, 32, 128, bf16, None, None),
        ("f32", 2, 1024, 1024, 32, 32, 128, f32, None, None),
        ("gqa8_bf16", 2, 1024, 1024, 32, 8, 128, bf16, None, None),
        ("window256_bf16", 2, 1024, 1024, 32, 32, 128, bf16, 256, None),
        ("sq333_sk1024_bf16", 2, 333, 1024, 32, 32, 128, bf16, None, None),
        ("doc4_bf16", 2, 1024, 1024, 32, 32, 128, bf16, None,
         [256, 384, 128, 256]),
    ]
    cases = []
    for name, B, sq, sk, h, hkv, d, dt, window, docs in specs:
        q, do = (torch.randn(B, sq, h, d, generator=g, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, sk, hkv, d, generator=g, device=dev).to(dt)
                for _ in range(2))
        se = None if docs is None else fa._normalize_startend(
            doc_mask(docs, device=dev), sq, sk, True)
        scale = d ** -0.5
        item = q.element_size()
        dname = str(dt).replace("torch.", "")
        keep = fa._keep_mask(sq, sk, h, True, window, se, dev)
        pairs = int(keep.sum()) * B * h // (keep.numel() // (sq * sk))

        def t(x):
            return x.transpose(1, 2).float()

        out, lse = fa.flash_fwd(q, k, v, True, scale, window, se,
                                want_lse=True)
        torch.cuda.synchronize()

        def plain_fwd():
            return fa.flash_plain(t(q), t(k), t(v), True, scale, window, se,
                                  return_lse=True)
        want, want_lse = plain_fwd()
        dead = want_lse <= fa.ROW_INVALID_LSE
        if not torch.equal(lse <= fa.ROW_INVALID_LSE, dead):
            fail(f"flash_fwd[{name}]: rows without keys disagree")
        res = {"out": closeness(out, want.transpose(1, 2)),
               "lse": closeness(lse[~dead], want_lse[~dead], rtol=0.0,
                                atol=1e-5 * max(1.0, float(
                                    want_lse[~dead].abs().max())))}
        del want, want_lse
        dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, True, scale, window,
                                  se)
        torch.cuda.synchronize()

        def plain_bwd():
            return fa.flash_bwd_plain(t(q), t(k), t(v), t(out), lse, t(do),
                                      True, scale, window, se)
        sharp = None
        for n, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), plain_bwd()):
            res[n] = closeness(got, ref.transpose(1, 2))
            if n == "dv" and name == "train_bf16":
                sharp = check_is_sharp(torch, fa, q, k, v, out, lse, do,
                                       scale, got, ref.transpose(1, 2))
        del dq, dk, dv
        errs = {n: r["max_abs_err"] for n, r in res.items()}
        tols = {n: r["tol"] for n, r in res.items()}
        ratios = {n: r["ratio"] for n, r in res.items()}
        bad = {n: r for n, r in res.items() if not r["ratio"] <= 1.0}
        if bad:
            fail(f"flash[{name}] disagrees with its plain version: {bad}")

        # timing: each kernel alone (raw launches, not counted), the whole
        # backward pass through its wrapper, the plain versions
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        args = (q, k, v, do, lse, delta)
        dq_b = torch.empty_like(q)
        dk_b, dv_b = torch.empty_like(k), torch.empty_like(v)
        rows = B * h * sq * 4
        qb, kb = q.numel() * item, k.numel() * item
        rec = dict(case=name, B=B, sq=sq, sk=sk, heads=h, kv_heads=hkv,
                   head_dim=d, dtype=dname, window=window, documents=docs,
                   pairs=pairs, max_abs_err=errs, tol=tols, ratio=ratios,
                   negative_control=sharp)
        rec["fwd"] = dict(
            ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, True, scale, window,
                                            se, want_lse=True), iters=10),
            plain_ms=cuda_ms(plain_fwd, iters=3))
        rec["fwd"].update(zip(("bound_ms", "bound_by"), bound_ms(
            2 * qb + 2 * kb + rows, 4 * pairs * d, dname)))
        rec["dq"] = dict(ms=cuda_ms(lambda: fa._bwd_launch(
            "flash_bwd_dq_launch", args, dq_b, None, True, scale, window,
            se), iters=10))
        rec["dq"].update(zip(("bound_ms", "bound_by"), bound_ms(
            3 * qb + 2 * kb + 2 * rows, 6 * pairs * d, dname)))
        rec["dkv"] = dict(ms=cuda_ms(lambda: fa._bwd_launch(
            "flash_bwd_dkv_launch", args, dk_b, dv_b, True, scale, window,
            se), iters=10))
        rec["dkv"].update(zip(("bound_ms", "bound_by"), bound_ms(
            2 * qb + 4 * kb + 2 * rows, 8 * pairs * d, dname)))
        plain_pass = cuda_ms(plain_bwd, iters=3)
        rec["pass"] = dict(
            ms=cuda_ms(lambda: fa.flash_bwd(q, k, v, out, lse, do, True,
                                            scale, window, se), iters=10),
            plain_ms=plain_pass)
        rec["pass"].update(zip(("bound_ms", "bound_by"), bound_ms(
            4 * qb + 4 * kb + rows, 10 * pairs * d, dname)))
        rec["dq"]["plain_ms"] = rec["dkv"]["plain_ms"] = plain_pass
        rec["fwd"]["library_ms"] = rec["pass"]["library_ms"] = None
        rec["library_note"] = (
            "aten flash attention takes bf16/fp16 with equal heads, sq == "
            "sk and no window or mask; it computes dq, dk and dv in one "
            "call, so its time stands beside the pass")
        if dt == bf16 and h == hkv and sq == sk and window is None \
                and se is None:
            qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
            aten = torch.ops.aten

            def lib_fwd():
                return aten._scaled_dot_product_flash_attention(
                    qt, kt, vt, 0.0, True, False, scale=scale)
            o_a, lse_a, cq, ck, mq, mk, seed, off, _ = lib_fwd()
            rec["fwd"]["library_ms"] = cuda_ms(lib_fwd, iters=10)
            rec["pass"]["library_ms"] = cuda_ms(
                lambda: aten._scaled_dot_product_flash_attention_backward(
                    dot, qt, kt, vt, o_a, lse_a, cq, ck, mq, mk, 0.0, True,
                    seed, off, scale=scale), iters=10)
            del o_a, lse_a
        rec["dq"]["library_ms"] = rec["dkv"]["library_ms"] = \
            rec["pass"]["library_ms"]
        print(f"  flash train[{name}]: err {errs} (ratio to tol {ratios}, "
              f"tol {tols}); fwd+lse "
              f"{rec['fwd']['ms']:.3f} ms (bound {rec['fwd']['bound_ms']:.3f}"
              f", plain {rec['fwd']['plain_ms']:.3f}, library "
              f"{rec['fwd']['library_ms']}); dQ {rec['dq']['ms']:.3f} ms "
              f"(bound {rec['dq']['bound_ms']:.3f}); dK/dV "
              f"{rec['dkv']['ms']:.3f} ms (bound {rec['dkv']['bound_ms']:.3f}"
              f"); pass {rec['pass']['ms']:.3f} ms (bound "
              f"{rec['pass']['bound_ms']:.3f}, plain {plain_pass:.3f}, "
              f"library {rec['pass']['library_ms']})", flush=True)
        cases.append(rec)
        del q, k, v, do, out, lse, delta, args, dq_b, dk_b, dv_b
        torch.cuda.empty_cache()
    return cases


def model_cross_check(torch, mods):
    """Phase 8: a small LLaMA on the card against the same weights on the
    CPU (the plain versions of the kernels): one TrainStep loss and every
    parameter gradient of the same loss, with a window, then with a
    document mask."""
    import numpy as np
    out = {}
    for name, extra, docs in (("window64", dict(sliding_window=64), None),
                              ("doc_mask", {}, [64, 96, 32, 64])):
        cfg = mods.LlamaConfig(**XCHECK_MODEL, **extra)
        nets = {"cuda": mods.LlamaForCausalLM(cfg, seed=1)}
        nets["cpu"] = mods.LlamaForCausalLM(cfg, device="cpu")
        nets["cpu"].load_state_dict(
            {k: v.cpu() for k, v in nets["cuda"].state_dict().items()})
        rng = np.random.default_rng(5)
        ids = rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int64)
        labels = rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int64)
        res = {}
        for dev, net in nets.items():
            inputs = [torch.from_numpy(ids).to(dev),
                      torch.from_numpy(labels).to(dev)]
            if docs is not None:
                inputs.append(mods.doc_mask(docs, device=dev))
            params = list(net.parameters())
            grads = torch.autograd.grad(net(*inputs), params)
            step = mods.TrainStep(net, lambda o, lab: o, mods.AdamW(
                1e-3, parameters=params))
            res[dev] = (float(step(tuple(inputs), inputs[1])),
                        [gr.cpu() for gr in grads])
        loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        grad_err = max(float((a - b).abs().max()
                             / b.abs().max().clamp(min=1e-30))
                       for a, b in zip(res["cuda"][1], res["cpu"][1]))
        out[name] = dict(loss_cuda=res["cuda"][0], loss_cpu=res["cpu"][0],
                         loss_rel_err=loss_err, max_rel_grad_err=grad_err,
                         grad_tol=XCHECK_GRAD_TOL, loss_tol=XCHECK_LOSS_TOL)
        print(f"model cross-check [{name}]: TrainStep loss cuda "
              f"{res['cuda'][0]:.6f} cpu {res['cpu'][0]:.6f} (rel err "
              f"{loss_err:.2e}, tol {XCHECK_LOSS_TOL}); max relative grad "
              f"error {grad_err:.2e} over {len(res['cpu'][1])} parameters "
              f"(tol {XCHECK_GRAD_TOL})", flush=True)
        if not (loss_err <= XCHECK_LOSS_TOL and grad_err <= XCHECK_GRAD_TOL):
            fail(f"model cross-check [{name}] off: {out[name]}")
        del nets, res
    torch.cuda.empty_cache()
    return out


def train_main_path(torch, mods, fa, monitor, card):
    """Phases 9 + 10: the training benchmark's configuration
    (profile_training's MODEL, BATCH and SEQ) for TRAIN_STEPS steps of one
    fixed batch, counts read around it."""
    batch, seq = mods.train.BATCH, mods.train.SEQ
    cfg = mods.LlamaConfig(**mods.train.MODEL)
    model = mods.LlamaForCausalLM(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    opt = mods.AdamW(3e-4, parameters=model.parameters(),
                     moment_dtype="bfloat16")
    step = mods.TrainStep(model, lambda out, lab: out, opt,
                          amp_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(4)
    ids, labels = (torch.randint(0, cfg.vocab_size, (batch, seq),
                                 generator=gen, device="cuda")
                   for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd.launches = 0
    fa.flash_bwd.launches_dq = fa.flash_bwd.launches_dkv = 0
    monitor.reset()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step((ids, labels), labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {"flash_fwd": fa.flash_fwd.launches,
                "flash_bwd_dq": fa.flash_bwd.launches_dq,
                "flash_bwd_dkv": fa.flash_bwd.launches_dkv}
    counters = {k: v for k, v in monitor.snapshot().items()
                if k.startswith("kernels.")}
    # -- end of the counted training path --
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = cfg.num_hidden_layers * TRAIN_STEPS
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"training losses not finite and falling: {losses}")
    if set(launches.values()) != {want}:
        fail(f"training launches {launches}, expected {want} each")
    if counters.get("kernels.flash.fwd_cuda") != want or \
            counters.get("kernels.flash.bwd_cuda") != want or \
            counters.get("kernels.flash.fwd_plain", 0) or \
            counters.get("kernels.flash.bwd_plain", 0):
        fail(f"training kernel-path counters disagree: {counters}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens = batch * seq
    flops = mods.llama_flops_per_token(cfg) * tokens
    rec = dict(params=n_params, batch=batch, seq=seq,
               steps=TRAIN_STEPS, losses=losses, step_s=times,
               ms_per_step=steady * 1e3, first_step_ms=times[0] * 1e3,
               tokens_per_s=tokens / steady,
               bf16_peak_share=flops / steady / PEAK_FLOPS["bfloat16"],
               peak_mem_gb=peak_gb, launches=launches, counters=counters)
    print(f"training: {n_params / 1e9:.3f} B params, batch {batch} x "
          f"seq {seq}, losses {[round(x, 4) for x in losses]}; "
          f"median step {rec['ms_per_step']:.1f} ms (first "
          f"{rec['first_step_ms']:.1f} ms) = {rec['tokens_per_s']:.0f} "
          f"tokens/s, {rec['bf16_peak_share']:.3f} of the 989 TFLOP/s bf16 "
          f"peak (llama_flops_per_token), peak memory {peak_gb:.1f} GB; "
          f"launches {launches} on {card}", flush=True)
    return rec


# -- phases 4 and 5: the main path -----------------------------------------

def make_requests(SamplingParams, vocab_size):
    import numpy as np
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(N_REQUESTS):
        n = int(rng.integers(PROMPT_LO, PROMPT_HI))
        prompt = rng.integers(0, vocab_size, (n,)).astype(np.int64)
        if i % 6 == 5:          # 4 of 24 sampled, the rest greedy
            sp = SamplingParams(max_new_tokens=NEW_TOKENS, temperature=0.8,
                                top_k=50 if i % 12 == 5 else 0,
                                top_p=0.9 if i % 12 == 11 else 0.0, seed=i)
        else:
            sp = SamplingParams(max_new_tokens=NEW_TOKENS)
        reqs.append((prompt, sp))
    return reqs


def teacher_forced_agreement(torch, model, prompt, tokens):
    """Share of `tokens` equal to the argmax of the no-cache forward over
    prompt + tokens[:-1] at each generated position."""
    import numpy as np
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int64)])
    with torch.no_grad():
        logits = model(torch.from_numpy(seq[None]).cuda())[0]
    want = logits[len(prompt) - 1:].argmax(-1).cpu().tolist()
    return sum(int(a == b) for a, b in zip(tokens, want)) / len(tokens)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    try:
        from types import SimpleNamespace

        from paddle_tpu_torch import monitor
        from paddle_tpu_torch import profile_training as train
        from paddle_tpu_torch.inference import Engine, SamplingParams
        from paddle_tpu_torch.jit import TrainStep
        from paddle_tpu_torch.kernels import _build as build
        from paddle_tpu_torch.kernels import flash_attention as fa
        from paddle_tpu_torch.kernels import paged_attention as pa
        from paddle_tpu_torch.nn.functional import \
            document_startend_row_indices as doc_mask
        from paddle_tpu_torch.optimizer import AdamW
        from paddle_tpu_torch.profile_serving import MODEL
        from paddle_tpu_torch.quantization import kv_quantize_arrays
        from paddle_tpu_torch.text.models import (LlamaConfig,
                                                  LlamaForCausalLM,
                                                  llama_flops_per_token)
        mods = SimpleNamespace(
            LlamaConfig=LlamaConfig, LlamaForCausalLM=LlamaForCausalLM,
            TrainStep=TrainStep, AdamW=AdamW, doc_mask=doc_mask,
            llama_flops_per_token=llama_flops_per_token, train=train)
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    # a reference states its float32 matmul precision: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}",
          flush=True)

    # 2. build (parallel nvcc) and load (each library runs its probe)
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    for name, log in build.build_logs.items():
        (OUT_DIR / f"nvcc_{name}.log").write_text(log)
    for name in build.SOURCES:
        build.load(name)
    print(f"build: {sorted(build.SOURCES)} in {build_s:.1f} s, probes ok",
          flush=True)

    # 3. kernels against their plain versions
    print("kernels vs plain versions:", flush=True)
    probe_cases = check_probe(torch, build)
    paged_cases = check_paged(torch, pa, kv_quantize_arrays)
    flash_cases = check_flash(torch, fa)
    train_cases = check_flash_train(torch, fa, doc_mask)

    # 4. + 5. the main path: counts to 0 just before, read just after
    build.probe.launches = 0
    pa.paged_decode.launches = 0
    fa.flash_fwd.launches = 0
    monitor.reset()
    cfg = LlamaConfig(**MODEL)
    model = LlamaForCausalLM(cfg, seed=0)
    model.eval()
    ids = torch.randint(0, cfg.vocab_size, (2, 1024),
                        generator=torch.Generator(device="cuda").manual_seed(2),
                        device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    flash_fwd_launches = fa.flash_fwd.launches
    if tuple(logits.shape) != (2, 1024, cfg.vocab_size):
        fail(f"forward logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail("forward logits are not finite")
    if flash_fwd_launches != cfg.num_hidden_layers:
        fail(f"flash kernel launched {flash_fwd_launches} times in the "
             f"forward, expected {cfg.num_hidden_layers}")
    del logits
    print(f"forward: [2, 1024] in {fwd_s * 1e3:.1f} ms (first call), "
          f"{flash_fwd_launches} flash launches", flush=True)

    eng = Engine(model, max_slots=16, page_size=128, prefill_bucket=64,
                 max_context=PROMPT_HI + NEW_TOKENS, cache_dtype="bfloat16")
    reqs = make_requests(SamplingParams, cfg.vocab_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"probe": build.probe.launches,
                "paged_decode": pa.paged_decode.launches,
                "flash_fwd": fa.flash_fwd.launches}
    counters = {k: v for k, v in monitor.snapshot().items()
                if k.startswith(("kernels.", "serving."))}
    # -- end of the counted main path --
    bad = [o for o in outs if not o.ok or len(o.token_ids) != NEW_TOKENS]
    if len(outs) != N_REQUESTS or bad:
        fail(f"serving: {len(outs)} outputs, failed/short: {bad[:2]}")
    ticks = eng.decode_ticks
    if launches["paged_decode"] != ticks * cfg.num_hidden_layers:
        fail(f"paged-decode launches {launches['paged_decode']} != "
             f"{ticks} ticks x {cfg.num_hidden_layers} layers")
    if counters.get("kernels.decode.paged_cuda") != launches["paged_decode"] \
            or counters.get("kernels.flash.fwd_cuda") != \
            launches["flash_fwd"] or counters.get(
                "kernels.decode.paged_plain", 0) or counters.get(
                "kernels.flash.fwd_plain", 0):
        fail(f"kernel-path counters disagree with launches: {counters}")
    if launches["probe"] < 1:
        fail("the engine did not run the kernel probe")
    if eng.leaked_pages():
        fail(f"{eng.leaked_pages()} pages leaked")
    n_tok = sum(len(o.token_ids) for o in outs)
    tok_s = n_tok / serve_s
    print(f"serving: {N_REQUESTS} requests, {n_tok} tokens, {ticks} decode "
          f"ticks, {counters.get('serving.preemptions', 0)} preemptions in "
          f"{serve_s:.2f} s = {tok_s:.1f} tok/s on {card}", flush=True)

    # 6. cross-check two greedy requests against the no-cache forward
    greedy = [i for i, (_, sp) in enumerate(reqs) if sp.temperature == 0][:2]
    f32_eng = Engine(model, max_slots=2, page_size=128, prefill_bucket=64,
                     max_context=PROMPT_HI + NEW_TOKENS,
                     cache_dtype="float32")
    f32_outs = f32_eng.run([reqs[i] for i in greedy])
    agree = {"bf16_pool": [], "f32_pool": []}
    for i, fo in zip(greedy, f32_outs):
        prompt = reqs[i][0]
        agree["bf16_pool"].append(teacher_forced_agreement(
            torch, model, prompt, outs[i].token_ids))
        agree["f32_pool"].append(teacher_forced_agreement(
            torch, model, prompt, fo.token_ids))
    print(f"cross-check (teacher-forced no-cache argmax agreement): "
          f"{agree} (thresholds f32 {AGREE_F32}, bf16 {AGREE_BF16})",
          flush=True)
    if min(agree["f32_pool"]) < AGREE_F32 or \
            min(agree["bf16_pool"]) < AGREE_BF16:
        fail(f"cross-check below threshold: {agree}")
    # the serving phase's model and engines go before training's
    del model, eng, f32_eng, outs, f32_outs
    torch.cuda.empty_cache()

    # 8. the model on the card against the CPU, at small depth
    xcheck = model_cross_check(torch, mods)

    # 9. + 10. the training main path: counts to 0 just before, read after
    training = train_main_path(torch, mods, fa, monitor, card)

    src = "paddle_tpu_torch/csrc/"
    main_paged = paged_cases[0]
    main_flash = flash_cases[0]
    main_train = train_cases[0]
    kernels = [
        dict(name="probe", route="cuda", source=src + "common.cuh",
             replaces="paddle_tpu/kernels/flash_attention.py:105",
             launches=launches["probe"], cases=probe_cases,
             **{k: probe_cases[0][k] for k in (
                 "max_abs_err", "tol", "ratio", "ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms")}),
        dict(name="paged_decode", route="cuda",
             source=src + "paged_decode.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:278",
             launches=launches["paged_decode"], cases=paged_cases,
             library_ms=None,
             **{k: main_paged[k] for k in (
                 "max_abs_err", "tol", "ratio", "ms", "plain_ms", "bound_ms",
                 "bound_by")}),
        dict(name="flash_fwd", route="cuda", source=src + "flash_fwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:280",
             launches=launches["flash_fwd"]
             + training["launches"]["flash_fwd"],
             launches_by_path={"serving": launches["flash_fwd"],
                               "training": training["launches"]["flash_fwd"]},
             cases=flash_cases,
             train=dict(case=main_train["case"],
                        max_abs_err=main_train["max_abs_err"]["out"],
                        lse_max_abs_err=main_train["max_abs_err"]["lse"],
                        ratio=max(main_train["ratio"][n]
                                  for n in ("out", "lse")),
                        **main_train["fwd"]),
             **{k: main_flash[k] for k in (
                 "max_abs_err", "tol", "ratio", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")}),
    ]
    for kname, part, line, grads in (
            ("flash_bwd_dq", "dq", 452, ("dq",)),
            ("flash_bwd_dkv", "dkv", 521, ("dk", "dv"))):
        kernels.append(dict(
            name=kname, route="cuda", source=src + "flash_bwd.cu",
            replaces=f"paddle_tpu/kernels/flash_attention.py:{line}",
            launches=training["launches"][kname],
            launches_by_path={"training": training["launches"][kname]},
            case=main_train["case"],
            max_abs_err=max(main_train["max_abs_err"][n] for n in grads),
            tol={n: main_train["tol"][n] for n in grads},
            ratio=max(main_train["ratio"][n] for n in grads),
            pass_ms=main_train["pass"]["ms"],
            pass_bound_ms=main_train["pass"]["bound_ms"],
            note="bound_ms counts this kernel's own function (S and dP "
                 "recomputed in each backward kernel); pass_bound_ms counts "
                 "one backward pass (2.5x the forward's operations); "
                 "plain_ms (flash_bwd_plain) and library_ms (the aten flash "
                 "backward, timed only, null where aten does not take the "
                 "case) each compute the whole pass, dq, dk and dv "
                 "together: compare them with pass_ms",
            cases=[dict(case=c["case"], **c[part]) for c in train_cases],
            **main_train[part]))
    for k in kernels:                 # also under these two names
        k["kernel_ms"], k["max_err"] = k["ms"], k["max_abs_err"]
    result = dict(card=card, kind=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  forward_ms_first_call=fwd_s * 1e3,
                  serving=dict(requests=N_REQUESTS, tokens=n_tok,
                               seconds=serve_s, tokens_per_s=tok_s,
                               decode_ticks=ticks,
                               preemptions=counters.get(
                                   "serving.preemptions", 0)),
                  counters=counters, agreement=agree,
                  flash_train_cases=train_cases, model_cross_check=xcheck,
                  training=training, kernels=kernels)
    (OUT_DIR / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
