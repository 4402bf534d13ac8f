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

11. MoE kernels: the grouped-FFN forward, dx and dw kernels against their
   plain versions at the MoE training shape (8 experts, capacity 8192,
   hidden 1024, expert FFN 2816, bf16, GELU, counts from a real top-2
   routing of the bench's 16,384 tokens), a decode tick (capacity 8, f32,
   one expert empty), a prefill chunk (capacity 128) and a ragged f32 ReLU
   case (hidden 96, FFN 200, capacity 37, counts 0 / full / odd), held
   stage by stage (rounded intermediates, then each output on the
   kernel's own intermediates) and end to end (within MOE_E2E_RATIO of
   the allowance), with a negative control (dw1 short of one expert's
   last 64-row tile must be rejected by both); each timed beside its
   plain version, its bound over the live rows and the timed-only pair
   of torch.bmm calls;
12. the MoE serving main path, counts set to 0 just before and read just
   after: ``bench.py::bench_ernie_moe_serving``'s configuration
   (``profile_moe``: 4 layers, 2 MoE, 8 experts, f32 weights from a seed)
   in an Engine with 8 slots, 128-token pages and a 64-token bucket, 16
   greedy requests of 64-191 prompt tokens and 96 new tokens: every
   request finished, no page leaked, grouped-FFN forward launches ==
   (prefills + decode ticks) x 2 MoE layers, paged-decode launches ==
   ticks x 4 layers, only the kernel dispatch, and two requests' tokens
   equal to a 1-slot engine's (>= 0.97);
13. MoE cross-check: a 2-layer ERNIE-MoE (hidden 256, 4 experts, seq 128,
   f32, TF32 off) — one TrainStep loss and every parameter gradient on
   the card within 1e-4 of the CPU's, once the router's top-3 margins of
   the inputs are above 1e-5;
14. the MoE training main path, counts set to 0 just before and read just
   after: ``bench.py::bench_ernie_moe``'s configuration (8 layers, 4 MoE,
   batch 32 x seq 512, CE + aux loss, bf16 AMP, AdamW(1e-4, bf16
   moments)) for 6 steps: finite, falling losses; grouped-FFN forward, dx
   and dw launches == 4 MoE layers x 6 steps, flash forward / dQ / dK/dV
   == 8 layers x 6 steps, no plain call; ms per step, tokens/s, the bf16
   peak share of ``ernie_moe_flops_per_token`` and the peak memory.

15. encoder kernels: the head-dim-64 probe of csrc/flash_fwd.cu (row 5:
   (x x^T) x on a seeded [128, 64] f32 tile of small integers, equal to
   its plain version bit for bit, timed beside it and the timed-only
   torch.matmul pair), the flash forward at the encoder's serving shape
   (B 16, 12 heads, head dim 64, f32, non-causal, C=1 key bands of a
   padding mask with 4 dead rows that must give zeros and ragged live
   lengths, L 128 and 96) beside the timed-only SDPA call, and the
   forward with logsumexp, dQ and dK/dV at the BERT training shape (B
   256, S 128, 12 heads, head dim 64, bf16, no mask);
16. the encoder serving main path, counts set to 0 just before the
   service is built and read just after: ``bench.py::bench_bert_embedding``'s
   configuration (``profile_encoder.BERT_EMBED``: BERT-base, f32 weights
   from a seed) in a BatchEncoder (max_batch 16, bucket 32) replaying the
   64-request trace twice (warm, then timed): every request done, flash
   forward launches == batches x 12 layers on the masked kernel route
   only, one head-dim-64 probe launch, no kernel build in steady state;
   4 requests' embeddings within 1e-4 relative of the same request
   encoded alone;
17. BERT cross-check: a 2-layer BertForPretraining at BERT-base widths
   (seq 128, f32, TF32 off, dropout 0, a padding mask) — one TrainStep
   loss and every parameter gradient on the card within 1e-4 of the
   CPU's;
18. the BERT training main path, counts set to 0 just before and read
   just after: ``bench.py::bench_bert``'s configuration
   (``profile_encoder.BERT_TRAIN``: batch 256 x seq 128, dense MLM CE,
   bf16 AMP, AdamW(1e-4, bf16 moments), dropout 0.1) for 6 steps:
   finite, falling losses; flash forward, dQ and dK/dV launches == 12
   layers x 6 steps, no plain call; ms per step, tokens/s, the bf16 peak
   share by bench_bert's 6N rule and the peak memory.

It prints the card line, a {"kernels": [...]} line, and as its last
line {"ok": true, "device": {...}}. Details land in
chiprun_out/chip_smoke/ (result JSON, nvcc/ptxas logs). About two
minutes of command time on an H100, the five kernel builds included.
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


#: phase 7's cases: name, B, sq, sk, h, hkv, d, dtype, window, documents,
#: causal — the LLaMA training shape (the first: the negative controls run
#: there) and five edge cases
LLAMA_TRAIN_SPECS = [
    ("train_bf16", 12, 1024, 1024, 32, 32, 128, "bfloat16", None, None,
     True),
    ("f32", 2, 1024, 1024, 32, 32, 128, "float32", None, None, True),
    ("gqa8_bf16", 2, 1024, 1024, 32, 8, 128, "bfloat16", None, None, True),
    ("window256_bf16", 2, 1024, 1024, 32, 32, 128, "bfloat16", 256, None,
     True),
    ("sq333_sk1024_bf16", 2, 333, 1024, 32, 32, 128, "bfloat16", None, None,
     True),
    ("doc4_bf16", 2, 1024, 1024, 32, 32, 128, "bfloat16", None,
     [256, 384, 128, 256], True),
]


def check_flash_train(torch, fa, doc_mask, specs=LLAMA_TRAIN_SPECS):
    """Phase 7 (and phase 15 at the BERT training shape): the flash
    forward with logsumexp, the dQ kernel and the dK/dV kernel against
    flash_plain / flash_bwd_plain (f32 math on the same rounded inputs).
    Each kernel is timed on its own; the bound of a kernel counts the
    operations of its own function (forward 4, dQ 6, dK/dV 8 x pairs x
    d, since each backward kernel recomputes S and dP), the pass bound
    counts the backward pass once (10 = 2.5 x the forward's)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    bf16 = torch.bfloat16
    cases = []
    for name, B, sq, sk, h, hkv, d, dname, window, docs, causal in specs:
        dt = getattr(torch, dname)
        q, do = (torch.randn(B, sq, h, d, generator=g, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, sk, hkv, d, generator=g, device=dev).to(dt)
                for _ in range(2))
        se = None if docs is None else fa._normalize_startend(
            doc_mask(docs, device=dev), sq, sk, causal)
        scale = d ** -0.5
        item = q.element_size()
        keep = fa._keep_mask(sq, sk, h, causal, window, se, dev)
        pairs = B * h * sq * sk if keep is None else \
            int(keep.sum()) * B * h // (keep.numel() // (sq * sk))

        def t(x):
            return x.transpose(1, 2).float()

        out, lse = fa.flash_fwd(q, k, v, causal, scale, window, se,
                                want_lse=True)
        torch.cuda.synchronize()

        def plain_fwd():
            return fa.flash_plain(t(q), t(k), t(v), causal, scale, window,
                                  se, return_lse=True)
        want, want_lse = plain_fwd()
        dead = want_lse <= fa.ROW_INVALID_LSE
        if not torch.equal(lse <= fa.ROW_INVALID_LSE, dead):
            fail(f"flash_fwd[{name}]: rows without keys disagree")
        res = {"out": closeness(out, want.transpose(1, 2)),
               "lse": closeness(lse[~dead], want_lse[~dead], rtol=0.0,
                                atol=1e-5 * max(1.0, float(
                                    want_lse[~dead].abs().max())))}
        del want, want_lse
        dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, causal, scale,
                                  window, se)
        torch.cuda.synchronize()

        def plain_bwd():
            return fa.flash_bwd_plain(t(q), t(k), t(v), t(out), lse, t(do),
                                      causal, scale, window, se)
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
                   causal=causal, pairs=pairs, max_abs_err=errs, tol=tols,
                   ratio=ratios, negative_control=sharp)
        rec["fwd"] = dict(
            ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, causal, scale, window,
                                            se, want_lse=True), iters=10),
            plain_ms=cuda_ms(plain_fwd, iters=3))
        rec["fwd"].update(zip(("bound_ms", "bound_by"), bound_ms(
            2 * qb + 2 * kb + rows, 4 * pairs * d, dname)))
        rec["dq"] = dict(ms=cuda_ms(lambda: fa._bwd_launch(
            "flash_bwd_dq_launch", args, dq_b, None, causal, scale, window,
            se), iters=10))
        rec["dq"].update(zip(("bound_ms", "bound_by"), bound_ms(
            3 * qb + 2 * kb + 2 * rows, 6 * pairs * d, dname)))
        rec["dkv"] = dict(ms=cuda_ms(lambda: fa._bwd_launch(
            "flash_bwd_dkv_launch", args, dk_b, dv_b, causal, scale, window,
            se), iters=10))
        rec["dkv"].update(zip(("bound_ms", "bound_by"), bound_ms(
            2 * qb + 4 * kb + 2 * rows, 8 * pairs * d, dname)))
        plain_pass = cuda_ms(plain_bwd, iters=3)
        rec["pass"] = dict(
            ms=cuda_ms(lambda: fa.flash_bwd(q, k, v, out, lse, do, causal,
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
                    qt, kt, vt, 0.0, causal, False, scale=scale)
            o_a, lse_a, cq, ck, mq, mk, seed, off, _ = lib_fwd()
            rec["fwd"]["library_ms"] = cuda_ms(lib_fwd, iters=10)
            rec["pass"]["library_ms"] = cuda_ms(
                lambda: aten._scaled_dot_product_flash_attention_backward(
                    dot, qt, kt, vt, o_a, lse_a, cq, ck, mq, mk, 0.0, causal,
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


# -- phases 11-14: the MoE path --------------------------------------------

#: the small on-card MoE cross-check model (one MoE block)
MOE_XCHECK_MODEL = dict(vocab_size=32000, hidden_size=256,
                        intermediate_size=704, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=4,
                        num_experts=4, moe_every=2, max_position_embeddings=128)
#: the smallest gap allowed between consecutive top-3 router probabilities
#: of the cross-check's tokens: card and CPU logits differ by f32 rounding,
#: so a closer tie could route differently, and a routing flip is then a
#: fault, not noise
MOE_MARGIN_MIN = 1e-5
#: greedy tokens of the 8-slot engine equal to a 1-slot engine's (a
#: request's tokens do not depend on its batch-mates)
MOE_AGREE = 0.97
#: the grouped-FFN kernels' end-to-end gate against their plain version,
#: in multiples of the element-wise allowance, by operand dtype. f32 is
#: held to the allowance itself. A bf16 output also carries the
#: intermediates' rounding flips (an ha or dz element whose f32 value
#: sits on a rounding midpoint rounds to the other neighbour), amplified
#: by the next product; the stage gate holds each rounding to one
#: allowance, and this bounds their sum: the sound kernels read up to
#: 2.94 (dx), a dw1 short of one row tile 424 (H100 runs of this script)
MOE_E2E_RATIO = {"float32": 1.0, "bfloat16": 8.0}


def _moe_counts(torch, moe_gate, n_tokens, h, e, cap, seed):
    """Per-expert counts of a real top-2 routing of n_tokens random tokens
    at capacity cap (router weights normal, std 0.02)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    tok = torch.randn(n_tokens, h, generator=g, device="cuda")
    wg = torch.randn(h, e, generator=g, device="cuda") * 0.02
    idx, _, keep, _, _ = moe_gate.topk_gating_sparse(tok @ wg, 2, cap,
                                                     train=False)
    owner = torch.where(keep, idx.long(), e)
    return torch.zeros(e + 1, dtype=torch.int32, device="cuda").index_add(
        0, owner.reshape(-1), keep.reshape(-1).to(torch.int32))[:e]


def _moe_negative_control(torch, moe, x, cnt, inter, dw1, ref_dw1,
                          plain_dw1, e2e_limit):
    """dw1 short of one expert's last live row tile (the tile loop one
    short): subtract that tile's share, x^T dz over its rows (the plain
    intermediate), and show that both gates reject it: the stage gate
    (against the plain formula on the kernel's intermediates) and the
    end-to-end gate (against the plain version, at ``e2e_limit``)."""
    e0 = int(torch.argmax(cnt))
    c = int(cnt[e0])
    lo = (c - 1) // moe.ROW_TILE * moe.ROW_TILE
    short = dw1.float()
    short[e0] -= x[e0, lo:c].float().T @ inter["dz"][e0, lo:c]
    short = short.to(dw1.dtype)
    stage, e2e = closeness(short, ref_dw1), closeness(short, plain_dw1)
    print(f"  negative control (dw1 without expert {e0}'s rows {lo}-{c - 1})"
          f": ratio to tol {stage['ratio']:.3g} (rejected: > 1), end to end "
          f"{e2e['ratio']:.3g} (rejected: > {e2e_limit})", flush=True)
    if not (stage["ratio"] > 1.0 and e2e["ratio"] > e2e_limit):
        fail(f"the checks do not reject dw1 short of a tile: {stage}, {e2e}")
    return dict(expert=e0, rows=[lo, c], ratio=stage["ratio"],
                ratio_vs_plain=e2e["ratio"], max_abs_err=stage["max_abs_err"])


def _moe_rounding_witness(torch, dt, dz_k, inter):
    """Where the dx kernel's rounded dz differs from the plain one: how
    many elements, how many of them by exactly one ulp of ``dt`` (same
    sign, neighbouring bit patterns), and how many of those have the
    plain f32 value within 0.05 ulp of the midpoint of the two neighbours
    (``at_midpoint``; ``median_offset_ulp`` over the one-ulp elements):
    there the two f32 values, which differ only by the order of
    summation, sit on either side of a rounding midpoint. Every other
    differing element is reported by its largest |dz| over the rms of the
    live dz (``others_max_abs_over_rms``) and its largest distance in
    ulps (``max_ulps``, same-sign pairs): values near 0, where the f32
    sums' own error exceeds half an ulp."""
    differ = dz_k != inter["dz"]
    a, b = dz_k[differ].to(dt), inter["dz"][differ].to(dt)
    v = inter["dz32"][differ]
    same = torch.signbit(a) == torch.signbit(b)
    ulps = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
    one = (ulps == 1) & same
    a, b = a.float(), b.float()
    off = torch.where(one, (v - (a + b) / 2).abs() / (a - b).abs(), 1.0)
    mid = off < 0.05
    live = inter["dz32"][inter["dz32"] != 0]
    rms = float(live.square().mean().sqrt()) if live.numel() else 0.0
    others = v[~mid].abs()
    return dict(elements=dz_k.numel(), differ=int(differ.sum()),
                one_ulp=int(one.sum()), at_midpoint=int(mid.sum()),
                median_offset_ulp=float(off[one].median()) if one.any()
                else None,
                others_max_abs_over_rms=float(others.max()) / rms
                if others.numel() else None,
                max_ulps=int(ulps[same].max()) if same.any() else None)


def check_moe_kernels(torch, moe, moe_gate):
    """Phase 11: the grouped-FFN forward, dx and dw kernels against their
    plain versions at the training shape (routed counts of the bench's
    16,384 tokens), a decode tick (8 lanes, one expert empty), a prefill
    chunk (cap 128, routed) and a ragged f32 case; each timed alone beside
    the plain version, its bound over the LIVE rows, and the timed-only
    pair of torch.bmm calls over the padded buffer.

    Two gates. Stage by stage, every compared value is f32 math on the
    same rounded inputs, rounded once (PR 2's element-wise rule applies):
    the dx kernel's rounded intermediates ha and dz of the live rows (its
    scratch) against the plain ones, and each output against the plain
    formula on the kernel's own intermediates (the forward's ha is the dx
    kernel's, bit for bit: same tiles, same order); db1 and db2, summed
    from f32, against the plain version directly. End to end, each output
    against the plain version within MOE_E2E_RATIO times its allowance
    (``ratio_vs_plain``): a bf16 output also carries the intermediates'
    rounding flips, amplified by the next product. For bf16, where the
    kernel's dz differs from the plain one is recorded
    (``_moe_rounding_witness``)."""
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    specs = [  # name, E, cap, h, dff, dtype, act, counts (or routed tokens)
        ("train_bf16", 8, 8192, 1024, 2816, bf16, "gelu", 16384),
        ("decode_f32", 8, 8, 1024, 2816, f32, "gelu",
         [2, 3, 0, 1, 4, 2, 2, 2]),
        ("prefill_f32", 8, 128, 1024, 2816, f32, "gelu", 128),
        ("ragged_f32", 3, 37, 96, 200, f32, "relu", [0, 37, 13]),
    ]
    names = ("out", "dx", "dw1", "db1", "dw2", "db2", "dws")
    cases = []
    for i, (name, E, cap, h, dff, dt, act, cspec) in enumerate(specs):
        cnt = (_moe_counts(torch, moe_gate, cspec, h, E, cap, 10 + i)
               if isinstance(cspec, int) else
               torch.tensor(cspec, dtype=torch.int32, device=dev))
        g = torch.Generator(device=dev).manual_seed(20 + i)

        def r(*shape, sc=1.0):
            return torch.randn(*shape, generator=g, device=dev) * sc
        ops = (r(E, cap, h, sc=0.5).to(dt), r(E, h, dff, sc=h ** -0.5).to(dt),
               r(E, 1, dff, sc=0.1), r(E, dff, h, sc=dff ** -0.5).to(dt),
               r(E, 1, h, sc=0.1), torch.rand(E, cap, 1, generator=g,
                                              device=dev))
        gg = r(E, cap, h).to(dt)
        got = dict(zip(names, (moe.grouped_ffn_fwd(*ops, cnt, act),)
                       + moe.grouped_ffn_bwd(*ops, cnt, gg, act)))
        # the dx kernel's rounded intermediates (scratch, live rows)
        cops = moe._check_cuda("check", *ops, cnt, gg)
        s = moe._bwd_scratch(ops[0], dff)
        dx_b, dw1_b, dw2_b = (torch.empty_like(t) for t in
                              (ops[0], ops[1], ops[3]))
        dws_b = torch.empty(E, cap, 1, device=dev)
        db2_b = torch.empty(E, 1, h, device=dev)
        db1_b = torch.empty(E, 1, dff, device=dev)
        moe._bwd_dx_launch(cops, s, dx_b, dws_b, db2_b, act)
        torch.cuda.synchronize()
        keep = moe._row_mask(cnt, cap, dev)
        ha_k = torch.where(keep, s["ha"].float(), 0.0)
        dz_k = torch.where(keep, s["dz"].float(), 0.0)
        dname = str(dt).replace("torch.", "")
        e2e_limit = MOE_E2E_RATIO[dname]
        inter = moe.grouped_ffn_bwd_intermediates(*ops, cnt, gg, act)
        plain = dict(zip(names, (moe.grouped_ffn_plain(*ops, cnt, act),)
                         + moe.grouped_ffn_bwd_outputs(*ops, cnt, gg,
                                                       **inter)))
        e2e = {n: closeness(got[n], plain[n]) for n in names}
        res = {n: closeness(a.to(dt), inter[n].to(dt))
               for n, a in (("ha", ha_k), ("dz", dz_k))}
        witness = (None if dt == f32 else
                   _moe_rounding_witness(torch, dt, dz_k, inter))
        ref = dict(zip(names, (moe.grouped_ffn_down_plain(
            ha_k, ops[3], ops[4], ops[5], cnt, dt),)
            + moe.grouped_ffn_bwd_outputs(*ops, cnt, gg, **dict(
                inter, ha=ha_k, dz=dz_k))))
        res.update({n: closeness(got[n], ref[n]) for n in names})
        sharp = None
        if name == "train_bf16":
            sharp = _moe_negative_control(torch, moe, ops[0], cnt, inter,
                                          got["dw1"], ref["dw1"],
                                          plain["dw1"], e2e_limit)
        del got, ref, plain, inter, ha_k, dz_k
        bad = {n: v for n, v in res.items() if not v["ratio"] <= 1.0}
        bad.update({f"{n} end to end": v for n, v in e2e.items()
                    if not v["ratio"] <= e2e_limit})
        if witness is not None:
            print(f"  grouped_ffn[{name}] dz, kernel vs plain: {witness}",
                  flush=True)
        if bad:
            fail(f"grouped_ffn[{name}] disagrees with its plain version: "
                 f"{bad}")

        # timing: each kernel alone (raw launches for dx and dw), the
        # plain versions, and the bmm pairs over the padded buffer. Bounds
        # count the port's own entries over the live rows: the forward 2
        # products, dx 4 (z, dh, dz w1^T, ha w2) writing ha and dz of the
        # live rows, dw 2 (dw1, dw2) reading them back and writing dw1
        # and dw2 of every expert.
        hbuf = r(E, cap, dff, sc=0.5).to(dt)
        x, w1, _, w2, _, _ = ops
        live = int(cnt.sum())
        item = x.element_size()
        wbytes = int((cnt > 0).sum()) * 2 * h * dff * item
        rows = live * h * item
        scratch = 2 * live * dff * item
        rec = dict(case=name, experts=E, cap=cap, hidden=h, dff=dff,
                   dtype=dname, activation=act, counts=cnt.tolist(),
                   live_rows=live,
                   max_abs_err={n: v["max_abs_err"] for n, v in res.items()},
                   tol={n: v["tol"] for n, v in res.items()},
                   ratio={n: v["ratio"] for n, v in res.items()},
                   ratio_vs_plain={n: v["ratio"] for n, v in e2e.items()},
                   e2e_limit=e2e_limit, dz_rounding=witness,
                   negative_control=sharp)
        plain_bwd = cuda_ms(lambda: moe.grouped_ffn_bwd_plain(
            *ops, cnt, gg, act), iters=3)
        parts = {
            "fwd": (lambda: moe.grouped_ffn_fwd(*ops, cnt, act),
                    cuda_ms(lambda: moe.grouped_ffn_plain(*ops, cnt, act),
                            iters=3),
                    (lambda: (torch.bmm(x, w1), torch.bmm(hbuf, w2))),
                    wbytes + 2 * rows + 4 * live, 4 * live * h * dff),
            "dx": (lambda: moe._bwd_dx_launch(cops, s, dx_b, dws_b, db2_b,
                                              act), plain_bwd,
                   (lambda: (torch.bmm(gg, w2.transpose(1, 2)),
                             torch.bmm(hbuf, w1.transpose(1, 2)))),
                   wbytes + 3 * rows + 8 * live + scratch,
                   8 * live * h * dff),
            "dw": (lambda: moe._bwd_dw_launch(cops, s, dw1_b, db1_b, dw2_b),
                   plain_bwd,
                   (lambda: (torch.bmm(x.transpose(1, 2), hbuf),
                             torch.bmm(hbuf.transpose(1, 2), gg))),
                   2 * rows + 4 * live + scratch + 2 * E * h * dff * item,
                   4 * live * h * dff),
        }
        for part, (fn, plain_ms, pair, nbytes, flops) in parts.items():
            bms, by = bound_ms(nbytes, flops, dname)
            rec[part] = dict(ms=cuda_ms(fn, iters=10), plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by, library_ms=None,
                             library_pair_ms=cuda_ms(pair, iters=10))
        print(f"  grouped_ffn[{name}]: ratio to tol "
              f"{ {n: round(v, 3) for n, v in rec['ratio'].items()} }, end "
              f"to end {max(rec['ratio_vs_plain'].values()):.3g} (limit "
              f"{e2e_limit}); " + "; ".join(f"{p} {rec[p]['ms']:.4f} ms (bound "
                          f"{rec[p]['bound_ms']:.4f} {rec[p]['bound_by']}, "
                          f"plain {rec[p]['plain_ms']:.4f}, bmm pair "
                          f"{rec[p]['library_pair_ms']:.4f})"
                          for p in ("fwd", "dx", "dw")), flush=True)
        cases.append(rec)
        del ops, gg, cops, s, dx_b, dw1_b, dw2_b, hbuf
        torch.cuda.empty_cache()
    return cases


def moe_serving_main_path(torch, mods, launches_of, reset_counts, card):
    """Phase 12: bench_ernie_moe_serving's configuration, counts set to 0
    just before it and read just after; then two requests again on a
    1-slot engine."""
    P = mods.moe_profile
    cfg = mods.ErnieMoEConfig(**P.MOE_SERVE_MODEL)
    model = mods.ErnieMoEForCausalLM(cfg, seed=0)
    model.eval()
    reqs = [(p, mods.SamplingParams(max_new_tokens=P.MOE_NEW_TOKENS))
            for p in P.moe_prompts(cfg.vocab_size)]
    torch.cuda.synchronize()
    reset_counts()
    eng = mods.Engine(model, **P.MOE_ENGINE)
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = launches_of()
    counters = {k: v for k, v in mods.monitor.snapshot().items()
                if k.startswith(("kernels.", "serving."))}
    # -- end of the counted MoE serving path --
    bad = [o for o in outs if not o.ok or len(o.token_ids) !=
           P.MOE_NEW_TOKENS]
    if len(outs) != P.MOE_REQUESTS or bad:
        fail(f"MoE serving: {len(outs)} outputs, failed/short: {bad[:2]}")
    if eng.leaked_pages():
        fail(f"MoE serving leaked {eng.leaked_pages()} pages")
    ticks = eng.decode_ticks
    prefills = int(counters.get("serving.prefill_slices", 0))
    n_moe = len(model.moe_layers())
    want = (prefills + ticks) * n_moe
    if launches["grouped_ffn_fwd"] != want or \
            counters.get("kernels.moe.grouped_ffn_fwd_cuda") != want:
        fail(f"grouped-FFN forward launches {launches['grouped_ffn_fwd']} "
             f"!= ({prefills} prefills + {ticks} ticks) x {n_moe} MoE layers")
    if launches["paged_decode"] != ticks * cfg.num_hidden_layers:
        fail(f"MoE serving paged-decode launches {launches['paged_decode']} "
             f"!= {ticks} ticks x {cfg.num_hidden_layers} layers")
    paths = eng.moe_decode_path()
    plain = {k: v for k, v in counters.items()
             if (k.endswith("_plain") or "fallback" in k) and v}
    if paths != {"pallas": want} or plain or \
            counters.get("serving.moe.decode_path.pallas") != want:
        fail(f"MoE serving left the kernel path: {paths}, {plain}")
    n_tok = sum(len(o.token_ids) for o in outs)
    one = mods.Engine(model, **dict(P.MOE_ENGINE, max_slots=1)).run(
        [reqs[0], reqs[1]])
    agree = [sum(int(a == b) for a, b in zip(outs[i].token_ids,
                                             one[i].token_ids))
             / len(one[i].token_ids) for i in range(2)]
    rec = dict(requests=P.MOE_REQUESTS, tokens=n_tok, seconds=serve_s,
               tokens_per_s=n_tok / serve_s, decode_ticks=ticks,
               prefills=prefills, launches=launches,
               moe_decode_path=paths, agreement_1_slot=agree,
               counters=counters)
    print(f"MoE serving: {P.MOE_REQUESTS} requests, {n_tok} tokens, {ticks} "
          f"decode ticks, {prefills} prefills in {serve_s:.2f} s = "
          f"{n_tok / serve_s:.1f} tok/s on {card}; launches {launches}; "
          f"8-slot vs 1-slot greedy agreement {agree} (threshold "
          f"{MOE_AGREE})", flush=True)
    if min(agree) < MOE_AGREE:
        fail(f"MoE serving: tokens depend on batch-mates: {agree}")
    return rec


def moe_cross_check(torch, mods):
    """Phase 13: a 2-layer ERNIE-MoE (one MoE block) on the card against
    the same weights on the CPU: one TrainStep loss and every parameter
    gradient, once the router's top-3 margins of the CPU's inputs are
    above MOE_MARGIN_MIN."""
    import numpy as np
    cfg = mods.ErnieMoEConfig(**MOE_XCHECK_MODEL)
    nets = {"cuda": mods.ErnieMoEForCausalLM(cfg, seed=1)}
    nets["cpu"] = mods.ErnieMoEForCausalLM(cfg, device="cpu")
    nets["cpu"].load_state_dict(
        {k: v.cpu() for k, v in nets["cuda"].state_dict().items()})
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int64)
    labels = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int64)
    res, seen = {}, {}
    for dev, net in (("cpu", nets["cpu"]), ("cuda", nets["cuda"])):
        def keep_input(module, args, dev=dev):
            seen.setdefault(dev, args[0].detach())      # returns None
        hook = net.moe_layers()[0].register_forward_pre_hook(keep_input)
        x, y = (torch.from_numpy(a).to(dev) for a in (ids, labels))
        ce = mods.CrossEntropyLoss()

        def loss_fn(out, lab, net=net, ce=ce):
            return ce(out, lab) + net.aux_loss()
        params = list(net.parameters())
        grads = torch.autograd.grad(loss_fn(net(x), y), params)
        hook.remove()
        step = mods.TrainStep(net, loss_fn, mods.AdamW(1e-3,
                                                       parameters=params))
        res[dev] = (float(step(x, y)), [gr.cpu() for gr in grads])
    h = seen["cpu"].reshape(-1, cfg.hidden_size)
    probs = torch.softmax(h @ nets["cpu"].moe_layers()[0].gate_weight.detach(),
                          dim=-1)
    top = probs.topk(3, dim=-1).values
    margin = float((top[:, :-1] - top[:, 1:]).min())
    loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(res["cuda"][1], res["cpu"][1]))
    rec = dict(loss_cuda=res["cuda"][0], loss_cpu=res["cpu"][0],
               loss_rel_err=loss_err, max_rel_grad_err=grad_err,
               min_top3_margin=margin, margin_min=MOE_MARGIN_MIN,
               grad_tol=XCHECK_GRAD_TOL, loss_tol=XCHECK_LOSS_TOL)
    print(f"MoE cross-check: smallest top-3 router margin {margin:.3g} "
          f"(min {MOE_MARGIN_MIN}); TrainStep loss cuda {res['cuda'][0]:.6f} "
          f"cpu {res['cpu'][0]:.6f} (rel err {loss_err:.2e}, tol "
          f"{XCHECK_LOSS_TOL}); max relative grad error {grad_err:.2e} over "
          f"{len(res['cpu'][1])} parameters (tol {XCHECK_GRAD_TOL})",
          flush=True)
    if not margin > MOE_MARGIN_MIN:
        fail(f"MoE cross-check inputs sit on a routing tie: {rec}")
    if not (loss_err <= XCHECK_LOSS_TOL and grad_err <= XCHECK_GRAD_TOL):
        fail(f"MoE cross-check off: {rec}")
    del nets, res
    torch.cuda.empty_cache()
    return rec


def moe_train_main_path(torch, mods, launches_of, reset_counts, card):
    """Phase 14: bench_ernie_moe's configuration for TRAIN_STEPS steps of
    one fixed batch, counts set to 0 just before and read just after."""
    P = mods.moe_profile
    cfg = mods.ErnieMoEConfig(**P.MOE_TRAIN_MODEL)
    model = mods.ErnieMoEForCausalLM(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    step = P.moe_train_step(model)
    gen = torch.Generator(device="cuda").manual_seed(4)
    ids, labels = (torch.randint(0, cfg.vocab_size, (P.MOE_BATCH, P.MOE_SEQ),
                                 generator=gen, device="cuda")
                   for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = launches_of()
    counters = {k: v for k, v in mods.monitor.snapshot().items()
                if k.startswith("kernels.")}
    # -- end of the counted MoE training path --
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_moe = len(model.moe_layers())
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"MoE training losses not finite and falling: {losses}")
    want = {"grouped_ffn_fwd": n_moe * TRAIN_STEPS,
            "grouped_ffn_bwd_dx": n_moe * TRAIN_STEPS,
            "grouped_ffn_bwd_dw": n_moe * TRAIN_STEPS,
            "flash_fwd": cfg.num_hidden_layers * TRAIN_STEPS,
            "flash_bwd_dq": cfg.num_hidden_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.num_hidden_layers * TRAIN_STEPS}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"MoE training launches {got}, expected {want}")
    plain = {k: v for k, v in counters.items()
             if (k.endswith("_plain") or "fallback" in k) and v}
    if plain or counters.get("kernels.moe.grouped_ffn_bwd_cuda") != \
            want["grouped_ffn_bwd_dx"] or counters.get(
                "kernels.flash.bwd_cuda") != want["flash_bwd_dq"]:
        fail(f"MoE training kernel-path counters disagree: {counters}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens = P.MOE_BATCH * P.MOE_SEQ
    flops = mods.ernie_moe_flops_per_token(cfg) * tokens
    rec = dict(params=n_params, batch=P.MOE_BATCH, seq=P.MOE_SEQ,
               steps=TRAIN_STEPS, losses=losses, step_s=times,
               ms_per_step=steady * 1e3, first_step_ms=times[0] * 1e3,
               tokens_per_s=tokens / steady,
               bf16_peak_share=flops / steady / PEAK_FLOPS["bfloat16"],
               peak_mem_gb=peak_gb, launches=launches, counters=counters)
    print(f"MoE training: {n_params / 1e6:.1f} M params, batch "
          f"{P.MOE_BATCH} x seq {P.MOE_SEQ}, losses "
          f"{[round(x, 4) for x in losses]}; median step "
          f"{rec['ms_per_step']:.1f} ms (first {rec['first_step_ms']:.1f} "
          f"ms) = {rec['tokens_per_s']:.0f} tokens/s, "
          f"{rec['bf16_peak_share']:.4f} of the 989 TFLOP/s bf16 peak "
          f"(ernie_moe_flops_per_token, routed), peak memory {peak_gb:.1f} "
          f"GB; launches {launches} on {card}", flush=True)
    return rec


# -- phases 15-18: the encoder path ----------------------------------------

#: phase 15's training case: BERT_TRAIN's attention, one layer (bf16,
#: head dim 64, bidirectional, no mask)
BERT_TRAIN_SPECS = [("bert_train_bf16", 256, 128, 128, 12, 12, 64,
                     "bfloat16", None, None, False)]
#: the small on-card BERT cross-check model: BERT-base widths, 2 layers
BERT_XCHECK_LAYERS, BERT_XCHECK_SEQ = 2, 128
#: batched embeddings against the same request encoded alone (f32, TF32
#: off: only the order of sums differs; the JAX service's contract)
EMBED_B1_RTOL = 1e-4
#: requests of the serving trace held to their b=1 embedding
EMBED_B1_REQUESTS = 4


def check_minor64_probe(torch, fa):
    """Phase 15a: the head-dim-64 probe of csrc/flash_fwd.cu through its
    wrapper (which raises on a wrong answer), equal to its plain version
    bit for bit on the wrapper's small-integer input; the kernel's own
    launch timed beside the plain version and, timed only, the pair of
    torch.matmul calls. The wrapper's whole call also holds the plain
    product it checks against and a host sync, so it is not what the
    kernel's time reads."""
    dev = torch.device("cuda")
    o = fa.probe_minor64(dev)
    x = fa.minor64_input(dev)
    want = fa.minor64_probe_plain(x)
    if not torch.equal(o, want):
        fail(f"the head-dim-64 probe disagrees with its plain version "
             f"(max err {max_err(o, want)})")
    n, d = fa.MINOR64_SHAPE
    bms, by = bound_ms(2 * x.numel() * 4, 2 * (2 * n * n * d), "float32")
    rec = dict(case="128x64_f32", max_abs_err=0.0, tol=0.0, ratio=0.0,
               ms=cuda_ms(lambda: fa._minor64_launch(x, o), iters=50),
               plain_ms=cuda_ms(lambda: fa.minor64_probe_plain(x), iters=50),
               library_ms=cuda_ms(lambda: torch.matmul(torch.matmul(x, x.T),
                                                       x), iters=50),
               bound_ms=bms, bound_by=by)
    print(f"  probe_minor64: equal to its plain version; kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, matmul pair "
          f"{rec['library_ms']:.4f} ms, bound {bms:.7f} ms ({by})",
          flush=True)
    return [rec]


def _key_lengths(torch, g, B, L, dead):
    """Live key lengths of a pinned batch: the last ``dead`` rows 0, one
    row the whole bucket, the rest ragged in [1, L)."""
    lens = torch.randint(1, L, (B,), generator=g, device="cuda")
    lens[0] = L
    lens[B - dead:] = 0
    return lens


def check_flash_encoder(torch, fa, F):
    """Phase 15b: the flash forward at the serving shape (B 16, H 12, D 64,
    f32, non-causal) with C=1 key bands from a pinned batch's padding mask
    — 4 dead rows whose every key is masked (they must give zeros),
    ragged live lengths — at L 128 and 96 (not a multiple of the 64-row q
    tile), timed beside the plain version and the timed-only SDPA call
    with the same bool mask. The bound counts what this data needs: the
    pairs (each live row's L queries times its live keys) and the bytes
    (Q of the live rows, K and V of the live keys, O of every row)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention   # timed only
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    B, H, D, dead = 16, 12, 64, 4
    cases = []
    for L in (128, 96):
        q, k, v = (torch.randn(B, L, H, D, generator=g, device=dev)
                   for _ in range(3))
        lens = _key_lengths(torch, g, B, L, dead)
        mask = torch.arange(L, device=dev)[None, :] < lens[:, None]
        keymask = mask[:, None, None, :]
        se = fa._normalize_startend(
            F._mask_to_key_bands(keymask, B, L, L, H), L, L, False)
        scale = D ** -0.5
        got = fa.flash_fwd(q, k, v, False, scale, None, se)
        torch.cuda.synchronize()

        def plain():
            return fa.flash_plain(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), False, scale,
                                  se=se).transpose(1, 2)
        c = closeness(got, plain())
        if not c["ratio"] <= 1.0:
            fail(f"flash_fwd[encoder L{L}] disagrees with its plain version: "
                 f"{c}")
        if got[B - dead:].any():
            fail(f"flash_fwd[encoder L{L}]: dead rows are not zero")
        pairs = int(lens.sum()) * L * H
        # the bytes the function needs: Q of the live batch rows (every
        # query of a live row sees its live keys), K and V of the live
        # keys only, O of every row (dead rows are written as zeros), and
        # the bands
        live_rows = int((lens > 0).sum())
        nbytes = (live_rows * L * H * D + 2 * int(lens.sum()) * H * D
                  + q.numel()) * 4 + se.numel() * 4
        bms, by = bound_ms(nbytes, 4 * pairs * D, "float32")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rec = dict(case=f"serving_f32_L{L}", B=B, sq=L, sk=L, heads=H,
                   head_dim=D, dtype="float32", dead_rows=dead,
                   live_keys=lens.tolist(), pairs=pairs, **c,
                   ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, False, scale,
                                                   None, se), iters=20),
                   plain_ms=cuda_ms(plain, iters=5),
                   library_ms=cuda_ms(lambda: sdpa(
                       qt, kt, vt, attn_mask=keymask), iters=20),
                   bound_ms=bms, bound_by=by)
        print(f"  flash_fwd[encoder L{L}]: err {c['max_abs_err']:.3g} (ratio "
              f"{c['ratio']:.3g}), dead rows zero; kernel {rec['ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, SDPA {rec['library_ms']:.4f} "
              f"ms, bound {bms:.4f} ms ({by})", flush=True)
        cases.append(rec)
    return cases


def encoder_serving_main_path(torch, mods, launches_of, reset_counts, card):
    """Phase 16: bench_bert_embedding's configuration (profile_encoder's
    BERT_EMBED), counts set to 0 just before the service is built and read
    just after the trace has run twice (warm, then timed); then
    EMBED_B1_REQUESTS requests held to the same request encoded alone."""
    import numpy as np
    enc = mods.enc
    E = enc.BERT_EMBED
    cfg = mods.BertConfig(**E["model"])
    model = mods.BertModel(cfg, seed=E["seed"])
    model.eval()
    trace = enc.embed_trace(cfg.vocab_size)
    torch.cuda.synchronize()
    reset_counts()
    # phase 15 already probed this card: forget it, so that the service
    # runs its head-dim-64 probe once inside the counted run
    mods.fa._minor64_ok.clear()
    svc = mods.BatchEncoder(model, max_batch=E["max_batch"],
                            bucket=E["bucket"])
    warm = enc.run_embed_trace(svc, trace)
    c_warm = dict(mods.monitor.snapshot())
    timed = enc.run_embed_trace(svc, trace)
    torch.cuda.synchronize()
    launches = launches_of()
    counters = {k: v for k, v in mods.monitor.snapshot().items()
                if k.startswith(("kernels.", "serving.embed."))}
    recompiles = svc.steady_state_recompiles()
    # -- end of the counted encoder serving path --
    outs = warm["outs"] + timed["outs"]
    bad = [o for o in outs if not o.ok or o.finish_reason != "done"]
    if len(outs) != 2 * E["n_requests"] or bad:
        fail(f"encoder serving: {len(outs)} outputs, failed: {bad[:2]}")
    batches = int(counters.get("serving.embed.batches", 0))
    want = batches * cfg.num_hidden_layers
    sdpa = {k: v for k, v in counters.items()
            if k.startswith("kernels.flash.sdpa.") and v}
    plain = {k: v for k, v in counters.items()
             if (k.endswith("_plain") or "fallback" in k) and v}
    if launches["flash_fwd"] != want or \
            counters.get("kernels.flash.fwd_cuda") != want:
        fail(f"encoder flash launches {launches['flash_fwd']} != {batches} "
             f"batches x {cfg.num_hidden_layers} layers")
    if sdpa != {"kernels.flash.sdpa.kernel_mask": want} or plain:
        fail(f"encoder serving left the masked kernel route: {sdpa} {plain}")
    if launches["probe_minor64"] != 1:
        fail(f"the encoder ran the head-dim-64 probe "
             f"{launches['probe_minor64']} times, expected 1")
    if recompiles != 0:
        fail(f"encoder serving built {recompiles} kernel libraries in "
             f"steady state")
    t_batches = batches - int(c_warm["serving.embed.batches"])
    t_tokens = counters["serving.embed.tokens"] - c_warm[
        "serving.embed.tokens"]
    t_pad = counters["serving.embed.pad_tokens"] - c_warm[
        "serving.embed.pad_tokens"]
    # batched against the same request encoded alone (no mask, b = 1)
    by_id = {o.req_id: o for o in timed["outs"]}
    first = min(by_id)
    b1 = []
    with torch.no_grad():
        for i in range(EMBED_B1_REQUESTS):
            ids = torch.from_numpy(trace[1][i][None]).cuda()
            x, pooled = model(ids)
            ref = pooled[0] if trace[2][i] == "cls" else x[0].mean(0)
            got = torch.from_numpy(by_id[first + i].embedding).cuda()
            b1.append(float((got - ref.float()).abs().max()
                            / ref.abs().max()))
    if max(b1) > EMBED_B1_RTOL:
        fail(f"batched embeddings differ from b=1: {b1}")
    steps = timed["steps"]
    rec = dict(requests=E["n_requests"], passes=2, batches=batches,
               timed=dict(seconds=timed["seconds"], batches=t_batches,
                          real_tokens=t_tokens, pad_tokens=t_pad,
                          tokens_per_s=t_tokens / timed["seconds"],
                          last_arrival_s=float(trace[0][-1]),
                          pad_share=t_pad / (t_tokens + t_pad),
                          steps=steps,
                          host_ms_per_step=timed["host_ms"] / steps,
                          device_ms_per_step=timed["device_ms"] / steps,
                          device_ms_per_batch=timed["device_ms"] / t_batches),
               warm_seconds=warm["seconds"], launches=launches,
               steady_state_recompiles=recompiles, b1_rel_err=b1,
               b1_rtol=EMBED_B1_RTOL, counters=counters)
    tm = rec["timed"]
    print(f"encoder serving: {E['n_requests']} requests x 2 passes, "
          f"{batches} batches, flash launches {launches['flash_fwd']} = "
          f"batches x {cfg.num_hidden_layers}, probe_minor64 "
          f"{launches['probe_minor64']}; timed pass {tm['seconds']:.3f} s, "
          f"{tm['batches']} batches, {tm['tokens_per_s']:.0f} real tokens/s "
          f"(arrival-bound: last arrival {tm['last_arrival_s']:.3f} s), "
          f"pad share {tm['pad_share']:.3f}, host "
          f"{tm['host_ms_per_step']:.2f} / device "
          f"{tm['device_ms_per_step']:.2f} ms per step, device "
          f"{tm['device_ms_per_batch']:.2f} ms per batch on {card}; batched vs "
          f"b=1 rel err {max(b1):.2e} (tol {EMBED_B1_RTOL})", flush=True)
    del svc, model
    torch.cuda.empty_cache()
    return rec


def bert_cross_check(torch, mods):
    """Phase 17: a 2-layer BertForPretraining at BERT-base widths, seq 128,
    f32, dropout 0, with a padding mask, on the card against the same
    weights on the CPU: one TrainStep loss and every parameter gradient
    of MLM loss + mean(nsp^2) (so the pooler and NSP head count too)."""
    import dataclasses
    import numpy as np
    cfg = mods.BertConfig(**mods.enc.BERT_TRAIN["model"])
    cfg = dataclasses.replace(cfg, num_hidden_layers=BERT_XCHECK_LAYERS,
                              hidden_dropout_prob=0.0)
    nets = {"cuda": mods.BertForPretraining(cfg, seed=1)}
    nets["cpu"] = mods.BertForPretraining(cfg, device="cpu")
    nets["cpu"].load_state_dict(
        {k: v.cpu() for k, v in nets["cuda"].state_dict().items()})
    rng = np.random.default_rng(7)
    shape = (2, BERT_XCHECK_SEQ)
    ids = rng.integers(0, cfg.vocab_size, shape).astype(np.int64)
    tt = rng.integers(0, 2, shape).astype(np.int64)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int64)
    am = np.ones(shape, np.int64)
    am[1, 88:] = 0

    def loss_fn(out, lab):
        return out[0] + out[1].square().mean()
    res = {}
    for dev, net in nets.items():
        inputs = tuple(torch.from_numpy(a).to(dev)
                       for a in (ids, tt, labels, am))
        params = list(net.parameters())
        grads = torch.autograd.grad(loss_fn(net(*inputs), None), params)
        step = mods.TrainStep(net, loss_fn, mods.AdamW(1e-3,
                                                       parameters=params))
        res[dev] = (float(step(inputs, inputs[2])),
                    [gr.cpu() for gr in grads])
    loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(res["cuda"][1], res["cpu"][1]))
    rec = dict(layers=BERT_XCHECK_LAYERS, seq=BERT_XCHECK_SEQ,
               loss_cuda=res["cuda"][0], loss_cpu=res["cpu"][0],
               loss_rel_err=loss_err, max_rel_grad_err=grad_err,
               grad_tol=XCHECK_GRAD_TOL, loss_tol=XCHECK_LOSS_TOL)
    print(f"BERT cross-check: TrainStep loss cuda {res['cuda'][0]:.6f} cpu "
          f"{res['cpu'][0]:.6f} (rel err {loss_err:.2e}, tol "
          f"{XCHECK_LOSS_TOL}); max relative grad error {grad_err:.2e} over "
          f"{len(res['cpu'][1])} parameters (tol {XCHECK_GRAD_TOL})",
          flush=True)
    if not (loss_err <= XCHECK_LOSS_TOL and grad_err <= XCHECK_GRAD_TOL):
        fail(f"BERT cross-check off: {rec}")
    del nets, res
    torch.cuda.empty_cache()
    return rec


def bert_train_main_path(torch, mods, launches_of, reset_counts, card):
    """Phase 18: bench_bert's configuration (profile_encoder's BERT_TRAIN)
    for TRAIN_STEPS steps of one fixed batch, dropout 0.1 from the
    model's generator, counts set to 0 just before and read just after."""
    enc = mods.enc
    T = enc.BERT_TRAIN
    cfg = mods.BertConfig(**T["model"])
    model = mods.BertForPretraining(cfg, seed=T["seed"])
    n_params = sum(p.numel() for p in model.parameters())
    step = enc.bert_train_step(model)
    inputs, labels = enc.train_batch(cfg.vocab_size, model.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(inputs, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = launches_of()
    counters = {k: v for k, v in mods.monitor.snapshot().items()
                if k.startswith("kernels.")}
    # -- end of the counted BERT training path --
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"BERT training losses not finite and falling: {losses}")
    want = cfg.num_hidden_layers * TRAIN_STEPS
    got = {k: launches[k] for k in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")}
    if set(got.values()) != {want}:
        fail(f"BERT training launches {got}, expected {want} each")
    sdpa = {k: v for k, v in counters.items()
            if k.startswith("kernels.flash.sdpa.") and v}
    plain = {k: v for k, v in counters.items()
             if (k.endswith("_plain") or "fallback" in k) and v}
    if plain or sdpa != {"kernels.flash.sdpa.kernel": want} or \
            counters.get("kernels.flash.bwd_cuda") != want:
        fail(f"BERT training kernel-path counters disagree: {counters}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens = T["batch"] * T["seq"]
    flops = enc.bert_flops_per_token(model) * tokens
    rec = dict(params=n_params, batch=T["batch"], seq=T["seq"],
               steps=TRAIN_STEPS, losses=losses, step_s=times,
               ms_per_step=steady * 1e3, first_step_ms=times[0] * 1e3,
               tokens_per_s=tokens / steady,
               bf16_peak_share_6n=flops / steady / PEAK_FLOPS["bfloat16"],
               peak_mem_gb=peak_gb, launches=launches, counters=counters)
    print(f"BERT training: {n_params / 1e6:.1f} M params, batch {T['batch']} "
          f"x seq {T['seq']}, dropout {cfg.hidden_dropout_prob}, losses "
          f"{[round(x, 4) for x in losses]}; median step "
          f"{rec['ms_per_step']:.1f} ms (first {rec['first_step_ms']:.1f} ms)"
          f" = {rec['tokens_per_s']:.0f} tokens/s, "
          f"{rec['bf16_peak_share_6n']:.4f} of the 989 TFLOP/s bf16 peak by "
          f"bench_bert's 6N rule, peak memory {peak_gb:.1f} GB; launches "
          f"{got} on {card}", flush=True)
    del step, model
    torch.cuda.empty_cache()
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
        from paddle_tpu_torch import profile_encoder as enc
        from paddle_tpu_torch import profile_moe as moe_profile
        from paddle_tpu_torch import profile_training as train
        from paddle_tpu_torch.incubate.distributed.models.moe import \
            gate as moe_gate
        from paddle_tpu_torch.inference import (BatchEncoder, Engine,
                                                SamplingParams)
        from paddle_tpu_torch.jit import TrainStep
        from paddle_tpu_torch.kernels import _build as build
        from paddle_tpu_torch.kernels import flash_attention as fa
        from paddle_tpu_torch.kernels import moe
        from paddle_tpu_torch.kernels import paged_attention as pa
        from paddle_tpu_torch.nn import CrossEntropyLoss
        from paddle_tpu_torch.nn import functional as F
        from paddle_tpu_torch.nn.functional import \
            document_startend_row_indices as doc_mask
        from paddle_tpu_torch.optimizer import AdamW
        from paddle_tpu_torch.profile_serving import MODEL
        from paddle_tpu_torch.quantization import kv_quantize_arrays
        from paddle_tpu_torch.text.models import (BertConfig,
                                                  BertForPretraining,
                                                  BertModel, ErnieMoEConfig,
                                                  ErnieMoEForCausalLM,
                                                  LlamaConfig,
                                                  LlamaForCausalLM,
                                                  ernie_moe_flops_per_token,
                                                  llama_flops_per_token)
        mods = SimpleNamespace(
            LlamaConfig=LlamaConfig, LlamaForCausalLM=LlamaForCausalLM,
            TrainStep=TrainStep, AdamW=AdamW, doc_mask=doc_mask,
            llama_flops_per_token=llama_flops_per_token, train=train,
            ErnieMoEConfig=ErnieMoEConfig,
            ErnieMoEForCausalLM=ErnieMoEForCausalLM,
            ernie_moe_flops_per_token=ernie_moe_flops_per_token,
            CrossEntropyLoss=CrossEntropyLoss, Engine=Engine,
            SamplingParams=SamplingParams, monitor=monitor,
            moe_profile=moe_profile, enc=enc, BertConfig=BertConfig,
            BertModel=BertModel, BertForPretraining=BertForPretraining,
            BatchEncoder=BatchEncoder, fa=fa)
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
    torch.cuda.empty_cache()

    # 11. the MoE kernels against their plain versions
    print("MoE kernels vs plain versions:", flush=True)
    moe_cases = check_moe_kernels(torch, moe, moe_gate)

    def reset_counts():
        build.probe.launches = 0
        fa.probe_minor64.launches = 0
        pa.paged_decode.launches = 0
        fa.flash_fwd.launches = 0
        fa.flash_bwd.launches_dq = fa.flash_bwd.launches_dkv = 0
        moe.grouped_ffn_fwd.launches = 0
        moe.grouped_ffn_bwd.launches_dx = moe.grouped_ffn_bwd.launches_dw = 0
        monitor.reset()

    def launches_of():
        return {"probe": build.probe.launches,
                "probe_minor64": fa.probe_minor64.launches,
                "paged_decode": pa.paged_decode.launches,
                "flash_fwd": fa.flash_fwd.launches,
                "flash_bwd_dq": fa.flash_bwd.launches_dq,
                "flash_bwd_dkv": fa.flash_bwd.launches_dkv,
                "grouped_ffn_fwd": moe.grouped_ffn_fwd.launches,
                "grouped_ffn_bwd_dx": moe.grouped_ffn_bwd.launches_dx,
                "grouped_ffn_bwd_dw": moe.grouped_ffn_bwd.launches_dw}

    # 12. the MoE serving main path, 13. the MoE cross-check, 14. the MoE
    # training main path (12 and 14 count their launches around them)
    moe_serving = moe_serving_main_path(torch, mods, launches_of,
                                        reset_counts, card)
    torch.cuda.empty_cache()
    moe_xcheck = moe_cross_check(torch, mods)
    moe_training = moe_train_main_path(torch, mods, launches_of,
                                       reset_counts, card)
    torch.cuda.empty_cache()

    # 15. the head-dim-64 probe and the flash kernels at the encoder's
    # shapes, 16. the encoder serving main path, 17. the BERT cross-check,
    # 18. the BERT training main path (16 and 18 count around them)
    print("encoder kernels vs plain versions:", flush=True)
    minor64_cases = check_minor64_probe(torch, fa)
    enc_flash_cases = check_flash_encoder(torch, fa, F)
    bert_train_cases = check_flash_train(torch, fa, doc_mask,
                                         BERT_TRAIN_SPECS)
    torch.cuda.empty_cache()
    enc_serving = encoder_serving_main_path(torch, mods, launches_of,
                                            reset_counts, card)
    bert_xcheck = bert_cross_check(torch, mods)
    bert_training = bert_train_main_path(torch, mods, launches_of,
                                         reset_counts, card)

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
    ms_l, mt_l = moe_serving["launches"], moe_training["launches"]
    kernels[0]["launches"] += ms_l["probe"]
    kernels[0]["launches_by_path"] = {"serving": launches["probe"],
                                      "moe_serving": ms_l["probe"]}
    kernels[1]["launches"] += ms_l["paged_decode"]
    kernels[1]["launches_by_path"] = {
        "serving": launches["paged_decode"],
        "moe_serving": ms_l["paged_decode"]}
    for k, name in zip(kernels[2:], ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")):
        k["launches"] += mt_l[name]
        k["launches_by_path"]["moe_training"] = mt_l[name]
    es_l, bt_l = enc_serving["launches"], bert_training["launches"]
    kernels[2]["launches"] += es_l["flash_fwd"]
    kernels[2]["launches_by_path"]["encoder_serving"] = es_l["flash_fwd"]
    kernels[2]["encoder_cases"] = enc_flash_cases
    for k, name in zip(kernels[2:], ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")):
        k["launches"] += bt_l[name]
        k["launches_by_path"]["bert_training"] = bt_l[name]
    bt_case = bert_train_cases[0]
    kernels[2]["bert_train"] = dict(
        case=bt_case["case"], max_abs_err=bt_case["max_abs_err"]["out"],
        ratio=max(bt_case["ratio"][n] for n in ("out", "lse")),
        **bt_case["fwd"])
    for k, part, grads in ((kernels[3], "dq", ("dq",)),
                           (kernels[4], "dkv", ("dk", "dv"))):
        k["cases"].append(dict(case=bt_case["case"], **bt_case[part]))
        k["bert_train"] = dict(
            case=bt_case["case"],
            max_abs_err=max(bt_case["max_abs_err"][n] for n in grads),
            ratio=max(bt_case["ratio"][n] for n in grads),
            pass_ms=bt_case["pass"]["ms"], **bt_case[part])
    main_moe = moe_cases[0]
    for kname, part, line, outs, paths in (
            ("grouped_ffn_fwd", "fwd", 181, ("out",),
             {"moe_serving": ms_l["grouped_ffn_fwd"],
              "moe_training": mt_l["grouped_ffn_fwd"]}),
            ("grouped_ffn_bwd_dx", "dx", 344, ("dx", "dws", "db2", "ha",
                                                "dz"),
             {"moe_training": mt_l["grouped_ffn_bwd_dx"]}),
            ("grouped_ffn_bwd_dw", "dw", 462, ("dw1", "db1", "dw2"),
             {"moe_training": mt_l["grouped_ffn_bwd_dw"]})):
        kernels.append(dict(
            name=kname, route="cuda",
            source=src + ("grouped_ffn_fwd.cu" if part == "fwd"
                          else "grouped_ffn_bwd.cu"),
            replaces=f"paddle_tpu/kernels/moe.py:{line}",
            launches=sum(paths.values()), launches_by_path=paths,
            case=main_moe["case"],
            max_abs_err=max(main_moe["max_abs_err"][n] for n in outs),
            tol={n: main_moe["tol"][n] for n in outs},
            ratio=max(main_moe["ratio"][n] for n in outs),
            ratio_vs_plain=max(main_moe["ratio_vs_plain"][n] for n in outs
                               if n in main_moe["ratio_vs_plain"]),
            e2e_limit=main_moe["e2e_limit"],
            note="bound_ms counts the port's own entry over the live rows: "
                 "forward 2 products (weights of the live experts, x in, "
                 "out written); dx 4 products (z, dh, dz w1^T, ha w2; the "
                 "weights, x and g in, dx written, ha and dz of the live "
                 "rows written for dw); dw 2 products (dw1, dw2; x, g, ha "
                 "and dz of the live rows in, dw1 and dw2 of every expert "
                 "written); library_ms is null (no single PyTorch call "
                 "computes a fused grouped FFN); library_pair_ms times two "
                 "torch.bmm calls over the padded buffer, timed only; "
                 "plain_ms of dx and dw is the whole plain backward; ratio "
                 "is the stage gate, ratio_vs_plain the end-to-end one "
                 "(limit e2e_limit)",
            cases=[dict(case=c["case"], **c[part]) for c in moe_cases],
            **main_moe[part]))
    kernels.insert(5, dict(
        name="probe_minor64", route="cuda", source=src + "flash_fwd.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:801",
        launches=es_l["probe_minor64"],
        launches_by_path={"encoder_serving": es_l["probe_minor64"]},
        cases=minor64_cases,
        note="library_ms times the pair of torch.matmul calls (timed only); "
             "the plain version is the same pair",
        **{k: minor64_cases[0][k] for k in (
            "max_abs_err", "tol", "ratio", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}))
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
                  training=training, moe_kernel_cases=moe_cases,
                  moe_serving=moe_serving, moe_cross_check=moe_xcheck,
                  moe_training=moe_training, minor64_cases=minor64_cases,
                  encoder_flash_cases=enc_flash_cases,
                  bert_flash_train_cases=bert_train_cases,
                  encoder_serving=enc_serving, bert_cross_check=bert_xcheck,
                  bert_training=bert_training, kernels=kernels)
    (OUT_DIR / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
