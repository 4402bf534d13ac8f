"""Where a training step's time goes, on one NVIDIA GPU.

    python -m paddle_tpu_torch.profile_training [--steps 2] [--out DIR]

Builds the training configuration chip_smoke.py drives (the JAX
package's ``bench.py::bench_llama_1b``: vocab 32000, hidden 4096, ff
11008, 32 heads, 4 layers, fused 4-chunk LM loss, f32 weights drawn from
a seed; batch 12 x seq 1024; TrainStep(amp_dtype="bfloat16") with
AdamW(3e-4, bf16 moments)), takes two warm-up steps, then

1. times ``--steps`` steps without the profiler (host clock around
   steps ending in a synchronize): ms per step and tokens/s;
2. records ``--steps`` more under ``torch.profiler`` (CPU + CUDA) and
   sums the device kernels of the exported trace: device-busy ms per
   step, the device idle share of the window, the kernels by device time
   and their sums by kind (the port's flash kernels, cuBLAS GEMMs,
   elementwise, copies and casts, reductions);
3. times two parts of a step alone with CUDA events: the AdamW update
   of every parameter (``apply_gradients_pytree``) and the bf16 cast of
   the parameters for the forward.

Prints one JSON line and writes it, with the chrome trace, to ``--out``
(default chiprun_out/profile_training). Needs a GPU: it raises otherwise.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from .jit import TrainStep
from .optimizer import AdamW
from .profile_serving import _kernel_times
from .text.models import LlamaConfig, LlamaForCausalLM

#: the training configuration, bench.py::bench_llama_1b's (chip_smoke.py
#: imports it too)
MODEL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
             num_hidden_layers=4, num_attention_heads=32,
             num_key_value_heads=32, max_position_embeddings=1024,
             fused_linear_ce=True, fused_ce_chunks=4)
BATCH, SEQ = 12, 1024


def _kind(name):
    for key, kind in (("flash_bwd_dkv", "flash dK/dV (port)"),
                      ("flash_bwd_dq", "flash dQ (port)"),
                      ("flash_fwd", "flash forward (port)"),
                      ("nvjet", "cuBLAS GEMM"), ("gemm", "cuBLAS GEMM"),
                      ("copy", "copies and casts"),
                      ("Memcpy", "copies and casts"),
                      ("reduce", "reductions"),
                      ("elementwise", "elementwise")):
        if key in name:
            return kind
    return "other"


def _device_ms(fn, iters=3):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _steps(step, ids, labels, n):
    for _ in range(n):
        step((ids, labels), labels)
    torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/profile_training")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    model = LlamaForCausalLM(LlamaConfig(**MODEL), seed=0)
    opt = AdamW(3e-4, parameters=model.parameters(), moment_dtype="bfloat16")
    step = TrainStep(model, lambda o, lab: o, opt, amp_dtype="bfloat16")
    gen = torch.Generator(device=model.device).manual_seed(4)
    ids, labels = (torch.randint(0, MODEL["vocab_size"], (BATCH, SEQ),
                                 generator=gen, device=model.device)
                   for _ in range(2))
    _steps(step, ids, labels, 2)                  # warm up

    t0 = time.perf_counter()
    _steps(step, ids, labels, args.steps)
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    trace = out / "trace.json"
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        _steps(step, ids, labels, args.steps)
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    prof.export_chrome_trace(str(trace))
    per = _kernel_times(trace)
    busy_ms = sum(v[0] for v in per.values()) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:16]
    kinds = {}
    for n, (us, _) in per.items():
        kinds[_kind(n)] = kinds.get(_kind(n), 0.0) + us / 1e3 / args.steps
    # the parts of a step timed alone (this moves the weights: last)
    params = step._params
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    opt_ms = _device_ms(lambda: opt.apply_gradients_pytree(
        params, zeros, step.opt_state, opt.get_lr()))
    cast_ms = _device_ms(lambda: [p.to(torch.bfloat16)
                                  for p in params.values()])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    result = {
        "device": card, "batch": BATCH, "seq": SEQ, "steps": args.steps,
        "step_ms": step_ms, "tokens_per_s": BATCH * SEQ * 1e3 / step_ms,
        "profiled_step_ms": prof_wall_ms / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": (1.0 - busy_ms / prof_wall_ms
                              if busy_ms else None),
        "optimizer_update_ms": opt_ms, "amp_cast_ms": cast_ms,
        "ms_per_step_by_kind": dict(sorted(kinds.items(),
                                           key=lambda kv: -kv[1])),
        "kernels": [{"name": n[:120], "ms_per_step": v[0] / 1e3 / args.steps,
                     "calls_per_step": v[1] / args.steps,
                     "share_of_busy": v[0] / 1e3 / busy_ms}
                    for n, v in top] if busy_ms else "not measured",
    }
    (out / "summary.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
