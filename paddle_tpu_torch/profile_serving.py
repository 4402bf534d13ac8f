"""Where a serving decode tick's time goes, on one NVIDIA GPU.

    python -m paddle_tpu_torch.profile_serving [--config llama|ernie_moe]
        [--steps 20] [--out DIR]

Builds a serving configuration chip_smoke.py drives, with f32 weights
drawn from a seed:

- ``llama`` (default): vocab 32000, hidden 4096, ff 11008, 32 heads, 4
  layers; Engine with 16 slots, 128-token pages, a 64-token prefill
  bucket, max context 320, bf16 pool;
- ``ernie_moe``: ``profile_moe``'s serving configuration
  (``bench.py::bench_ernie_moe_serving``: hidden 1024, expert FFN 2816,
  4 layers of which 2 MoE, 16 heads, 8 experts, top-2) in its Engine (8
  slots, 128-token pages, a 64-token bucket, f32 pool): each tick runs
  paged decode in every layer and the grouped-FFN forward at capacity 8
  in every MoE layer.

It fills every slot with a greedy request (128-token prompts), lets a
few steps warm up, then

1. times ``--steps`` steady decode steps without the profiler (host
   clock around steps ending in a synchronize): ms per step and
   tokens/s;
2. records ``--steps`` more under ``torch.profiler`` (CPU + CUDA) and
   sums the device kernels of the exported trace: device-busy ms per
   step and the device idle share of the window (busy: the union of the
   device intervals), the port's paged-decode and grouped-FFN kernels
   per step (the union of theirs), and the kernels by device time.

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


def _union_us(spans):
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def _kernel_times(trace_path):
    """({kernel name: [device µs, calls]}, [(name, start, end) µs]) of the
    device activity (kernels, copies, memsets) of a chrome trace exported
    by torch.profiler."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    per = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset"):
            per[e["name"]][0] += e.get("dur", 0.0)
            per[e["name"]][1] += 1
            spans.append((e["name"], e["ts"], e["ts"] + e.get("dur", 0.0)))
    return per, spans


#: the port's kernels a tick runs, summed by the name's substring
PORT_KERNELS = ("paged_decode", "grouped_ffn")


def build_engine(config):
    """(engine, slots, vocab) of a serving configuration."""
    if config == "llama":
        model = LlamaForCausalLM(LlamaConfig(**MODEL), seed=0)
        model.eval()
        return Engine(model, max_slots=16, page_size=128, prefill_bucket=64,
                      max_context=320, cache_dtype="bfloat16"), 16, \
            MODEL["vocab_size"]
    from .profile_moe import MOE_ENGINE, MOE_SERVE_MODEL
    from .text.models import ErnieMoEConfig, ErnieMoEForCausalLM
    model = ErnieMoEForCausalLM(ErnieMoEConfig(**MOE_SERVE_MODEL), seed=0)
    model.eval()
    return Engine(model, **MOE_ENGINE), MOE_ENGINE["max_slots"], \
        MOE_SERVE_MODEL["vocab_size"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("llama", "ernie_moe"),
                    default="llama")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/profile_serving")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    eng, slots, vocab = build_engine(args.config)
    rng = np.random.default_rng(0)
    budget = 4 + 2 * args.steps + 2
    for _ in range(slots):
        eng.add_request(rng.integers(0, vocab, (128,)),
                        SamplingParams(max_new_tokens=budget))
    _steps(eng, 4)                   # prefill every slot, warm decode
    if eng.num_active != slots:
        raise RuntimeError(f"{eng.num_active} of {slots} slots decoding")

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
    # busy time is the union of the device intervals: a programmatic
    # dependent launch (the rows route's later passes) starts during the
    # kernel before it and waits, so their durations overlap
    per, spans = _kernel_times(trace)
    busy_ms = _union_us([sp[1:] for sp in spans]) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    port = {k: [_union_us([sp[1:] for sp in spans if k in sp[0]]) / 1e3
                / args.steps,
                sum(v[1] for n, v in per.items() if k in n) / args.steps]
            for k in PORT_KERNELS}
    result = {
        "device": card, "config": args.config, "slots": slots,
        "steps": args.steps,
        "step_ms": step_ms, "tokens_per_s": slots * 1e3 / step_ms,
        "profiled_step_ms": prof_wall_ms / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": (1.0 - busy_ms / prof_wall_ms
                              if busy_ms else None),
        "port_kernels": {k: {"ms_per_step": v[0], "calls_per_step": v[1]}
                         for k, v in port.items()} if busy_ms
        else "not measured",
        "kernels": [{"name": n[:120], "ms_per_step": v[0] / 1e3 / args.steps,
                     "calls_per_step": v[1] / args.steps,
                     "share_of_busy": v[0] / 1e3 / busy_ms}
                    for n, v in top] if busy_ms else "not measured",
    }
    (out / "summary.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
