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

It prints the card line, a {"kernels": [...]} line, and as its last
line {"ok": true, "device": {...}}. Details land in
chiprun_out/chip_smoke/ (result JSON, nvcc/ptxas logs).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

MODEL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
             num_hidden_layers=4, num_attention_heads=32,
             num_key_value_heads=32, max_position_embeddings=320,
             use_flash_attention=True)
N_REQUESTS, PROMPT_LO, PROMPT_HI, NEW_TOKENS = 24, 64, 192, 128
#: cross-check thresholds: share of greedy tokens equal to the
#: teacher-forced argmax of the no-cache f32 forward (an f32 pool only
#: differs by summation order; a bf16 pool rounds K/V to 8 bits)
AGREE_F32, AGREE_BF16 = 0.97, 0.85


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
    specs = [("serving_bf16", 32, 32, torch.bfloat16, None, 1e-2),
             ("serving_f32", 32, 32, torch.float32, None, 1e-4),
             ("int8", 32, 32, torch.int8, None, 1e-4),
             ("gqa_rep4", 32, 8, torch.bfloat16, None, 1e-2),
             ("window", 32, 32, torch.bfloat16, 100, 1e-2)]
    for name, h, hkv, dt, window, rtol in specs:
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
        err = max_err(got, want)
        tol = rtol * max(1.0, float(want.abs().max()))
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
                   pool=str(dt).replace("torch.", ""), window=window,
                   max_abs_err=err, tol=tol,
                   ms=cuda_ms(lambda: pa.paged_decode(*args, **kw)),
                   plain_ms=cuda_ms(lambda: pa.paged_attention_arrays(
                       *args, **kw)),
                   bound_ms=bms, bound_by=by, live_tokens=toks)
        print(f"  paged_decode[{name}]: err {err:.3g} (tol {tol:.3g}) "
              f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"bound {bms:.4f} ms ({by})", flush=True)
        if not err <= tol:
            fail(f"paged_decode[{name}] disagrees with its plain version: "
                 f"max abs err {err} > {tol}")
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
        want = plain()
        err = max_err(got, want)
        rtol = 1e-4 if dt == torch.float32 else 1e-2
        tol = rtol * max(1.0, float(want.abs().max()))
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
                   window=window, max_abs_err=err, tol=tol,
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
        print(f"  flash_fwd[{name}]: err {err:.3g} (tol {tol:.3g}) kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"library {rec['library_ms']}, bound {bms:.4f} ms ({by})",
              flush=True)
        if not err <= tol:
            fail(f"flash_fwd[{name}] disagrees with its plain version: max "
                 f"abs err {err} > {tol}")
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
    return [dict(case="8x128_f32", max_abs_err=err, tol=0.0,
                 ms=cuda_ms(launch), plain_ms=plain, library_ms=plain,
                 bound_ms=bms, bound_by=by)]


# -- phases 4 and 5: the main path -----------------------------------------

def make_requests(SamplingParams):
    import numpy as np
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(N_REQUESTS):
        n = int(rng.integers(PROMPT_LO, PROMPT_HI))
        prompt = rng.integers(0, MODEL["vocab_size"], (n,)).astype(np.int64)
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
        from paddle_tpu_torch import monitor
        from paddle_tpu_torch.inference import Engine, SamplingParams
        from paddle_tpu_torch.kernels import _build as build
        from paddle_tpu_torch.kernels import flash_attention as fa
        from paddle_tpu_torch.kernels import paged_attention as pa
        from paddle_tpu_torch.quantization import kv_quantize_arrays
        from paddle_tpu_torch.text.models import (LlamaConfig,
                                                  LlamaForCausalLM)
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
    reqs = make_requests(SamplingParams)
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

    src = "paddle_tpu_torch/csrc/"
    main_paged = paged_cases[0]
    main_flash = flash_cases[0]
    kernels = [
        dict(name="probe", route="cuda", source=src + "common.cuh",
             replaces="paddle_tpu/kernels/flash_attention.py:105",
             launches=launches["probe"], cases=probe_cases,
             **{k: probe_cases[0][k] for k in (
                 "max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")}),
        dict(name="paged_decode", route="cuda",
             source=src + "paged_decode.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:278",
             launches=launches["paged_decode"], cases=paged_cases,
             library_ms=None,
             **{k: main_paged[k] for k in (
                 "max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                 "bound_by")}),
        dict(name="flash_fwd", route="cuda", source=src + "flash_fwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:280",
             launches=launches["flash_fwd"], cases=flash_cases,
             **{k: main_flash[k] for k in (
                 "max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")}),
    ]
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
                  counters=counters, agreement=agree, kernels=kernels)
    (OUT_DIR / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
