"""Where a serving decode tick's time goes, on one NVIDIA GPU.

    python -m paddle_tpu_torch.profile_serving [--steps 20] [--out DIR]

Builds the serving configuration chip_smoke.py drives (vocab 32000,
hidden 4096, ff 11008, 32 heads, 4 layers, f32 weights drawn from a
seed; Engine with 16 slots, 128-token pages, a 64-token prefill bucket,
max context 320, bf16 pool), fills all 16 slots with greedy requests
(128-token prompts), lets a few steps warm up, then

1. times ``--steps`` steady decode steps without the profiler (host
   clock around steps ending in a synchronize): ms per step and
   tokens/s;
2. records ``--steps`` more under ``torch.profiler`` (CPU + CUDA) and
   sums the device kernels of the exported trace: device-busy ms per
   step, the device idle share of the window, and the kernels by device
   time.

Prints one JSON line and writes it, with the chrome trace, to ``--out``
(default chiprun_out/profile_serving). Needs a GPU: it raises otherwise.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from .inference import Engine, SamplingParams
from .text.models import LlamaConfig, LlamaForCausalLM

#: the serving configuration (chip_smoke.py imports it too)
MODEL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
             num_hidden_layers=4, num_attention_heads=32,
             num_key_value_heads=32, max_position_embeddings=320)


def _steps(eng, n):
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()


def _kernel_times(trace_path):
    """{kernel name: [device µs, calls]} over the device activity
    (kernels, copies, memsets) of a chrome trace exported by
    torch.profiler."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    per = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset"):
            per[e["name"]][0] += e.get("dur", 0.0)
            per[e["name"]][1] += 1
    return per


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/profile_serving")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    model = LlamaForCausalLM(LlamaConfig(**MODEL), seed=0)
    model.eval()
    eng = Engine(model, max_slots=16, page_size=128, prefill_bucket=64,
                 max_context=320, cache_dtype="bfloat16")
    rng = np.random.default_rng(0)
    budget = 4 + 2 * args.steps + 2
    for _ in range(16):
        eng.add_request(rng.integers(0, MODEL["vocab_size"], (128,)),
                        SamplingParams(max_new_tokens=budget))
    _steps(eng, 4)                   # prefill all 16 slots, warm decode
    if eng.num_active != 16:
        raise RuntimeError(f"{eng.num_active} of 16 slots decoding")

    t0 = time.perf_counter()
    _steps(eng, args.steps)
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    trace = out / "trace.json"
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        _steps(eng, args.steps)
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    prof.export_chrome_trace(str(trace))
    per = _kernel_times(trace)
    busy_ms = sum(v[0] for v in per.values()) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    result = {
        "device": card, "slots": 16, "steps": args.steps,
        "step_ms": step_ms, "tokens_per_s": 16 * 1e3 / step_ms,
        "profiled_step_ms": prof_wall_ms / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": (1.0 - busy_ms / prof_wall_ms
                              if busy_ms else None),
        "kernels": [{"name": n[:120], "ms_per_step": v[0] / 1e3 / args.steps,
                     "calls_per_step": v[1] / args.steps,
                     "share_of_busy": v[0] / 1e3 / busy_ms}
                    for n, v in top] if busy_ms else "not measured",
    }
    (out / "summary.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
