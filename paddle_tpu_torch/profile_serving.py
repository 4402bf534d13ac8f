"""Where a serving decode tick's time goes, on one NVIDIA GPU.

    python -m paddle_tpu_torch.profile_serving [--config llama|ernie_moe]
        [--multi-tick K [K ...]] [--pairs N] [--steps 12] [--out DIR]

Builds a serving configuration chip_smoke.py drives, with f32 weights
drawn from a seed:

- ``llama`` (default): vocab 32000, hidden 4096, ff 11008, 32 heads, 4
  layers; Engine with 16 slots, 128-token pages, a 64-token prefill
  bucket, a bf16 pool and a max context of 384 (3 pages a slot, as the
  bench's 320);
- ``ernie_moe``: ``profile_moe``'s serving configuration
  (``bench.py::bench_ernie_moe_serving``: hidden 1024, expert FFN 2816,
  4 layers of which 2 MoE, 16 heads, 8 experts, top-2) in its Engine (8
  slots, 128-token pages, a 64-token bucket): each tick runs paged
  decode in every layer and the grouped-FFN forward at capacity 8 in
  every MoE layer.

For each ``--multi-tick`` value in turn, ``--pairs`` times (one model,
an engine a run), it fills every slot with a greedy request (128-token
prompts), lets two steps prefill and warm up (capturing the multi-tick
graph), then

1. times ``--steps`` steady decode steps without the profiler (host
   clock around steps ending in a synchronize): ms per step (a step is
   k device ticks under ``multi_tick=k``), ms per device tick, tokens/s,
   the engine's host ms a tick (``serving.hist.host_ms_per_tick``: the
   host time not hidden under a dispatch), its overlap ms a tick (host
   work that ran while the device executed the dispatch,
   ``serving.hist.overlap_ms_per_tick``) and their sum, the host's own
   work a tick (``host_work_ms_per_tick``: the step's wall time less its
   blocking waits, the quantity older engines booked as host time);
2. records ``--steps`` more under ``torch.profiler`` (CPU + CUDA) and
   sums the device kernels of the exported trace: device-busy ms per
   step and per tick and the device idle share of the window (busy: the
   union of the device intervals), the port's paged-decode and
   grouped-FFN kernels per tick (the union of theirs), and the kernels
   by device time.

Prints one JSON line per run and a last one with every run and the
medians and quartiles by k, and writes it, with the last run's chrome
trace, to
``--out`` (default chiprun_out/profile_serving). Needs a GPU: it raises
otherwise.
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

from . import monitor
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


def build_model(config):
    """(model, engine kwargs, slots, vocab) of a serving configuration."""
    if config == "llama":
        model = LlamaForCausalLM(LlamaConfig(**MODEL), seed=0)
        kw = dict(max_slots=16, page_size=128, prefill_bucket=64,
                  max_context=384, cache_dtype="bfloat16")
        vocab = MODEL["vocab_size"]
    else:
        from .profile_moe import MOE_ENGINE, MOE_SERVE_MODEL
        from .text.models import ErnieMoEConfig, ErnieMoEForCausalLM
        model = ErnieMoEForCausalLM(ErnieMoEConfig(**MOE_SERVE_MODEL),
                                    seed=0)
        kw = dict(MOE_ENGINE, max_context=384)
        vocab = MOE_SERVE_MODEL["vocab_size"]
    model.eval()
    return model, kw, kw["max_slots"], vocab


def profile_run(model, kw, slots, vocab, k, steps, out):
    """One engine at ``multi_tick=k``: the timed and the profiled window
    (see the module docstring). Returns the run's summary."""
    eng = Engine(model, multi_tick=k, **kw)
    rng = np.random.default_rng(0)
    for _ in range(slots):
        eng.add_request(rng.integers(0, vocab, (128,)),
                        SamplingParams(max_new_tokens=256))
    _steps(eng, 2)                   # prefill every slot, warm decode
    if eng.num_active != slots:
        raise RuntimeError(f"{eng.num_active} of {slots} slots decoding")
    host = monitor.histogram("serving.hist.host_ms_per_tick")
    overlap = monitor.histogram("serving.hist.overlap_ms_per_tick")
    h0, o0, t_0 = host.sum, overlap.sum, eng.decode_ticks
    tok0 = monitor.counter("serving.tokens").get()
    t0 = time.perf_counter()
    _steps(eng, steps)
    wall_ms = (time.perf_counter() - t0) * 1e3
    ticks = eng.decode_ticks - t_0
    tokens = monitor.counter("serving.tokens").get() - tok0
    host_ms = host.sum - h0
    overlap_ms = overlap.sum - o0

    trace = out / "trace.json"
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t_1 = eng.decode_ticks
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        _steps(eng, steps)
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    prof.export_chrome_trace(str(trace))
    prof_ticks = eng.decode_ticks - t_1
    if eng.num_active != slots:
        raise RuntimeError("a request finished inside the windows")
    # busy time is the union of the device intervals: a programmatic
    # dependent launch (the rows route's later passes) starts during the
    # kernel before it and waits, so their durations overlap
    per, spans = _kernel_times(trace)
    busy_ms = _union_us([sp[1:] for sp in spans]) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
    port = {n: [_union_us([sp[1:] for sp in spans if n in sp[0]]) / 1e3
                / prof_ticks,
                sum(v[1] for m, v in per.items() if n in m) / prof_ticks]
            for n in PORT_KERNELS}
    return {
        "multi_tick": k, "steps": steps, "ticks": ticks,
        "step_ms": wall_ms / steps, "tick_ms": wall_ms / ticks,
        "tokens_per_s": tokens * 1e3 / wall_ms,
        "host_ms_per_tick": host_ms / ticks,
        "overlap_ms_per_tick": overlap_ms / ticks,
        "host_work_ms_per_tick": (host_ms + overlap_ms) / ticks,
        "fused_graphs": eng._multi.captured if eng._multi else [],
        "profiled_step_ms": prof_wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_busy_ms_per_tick": busy_ms / prof_ticks,
        "device_idle_share": (1.0 - busy_ms / prof_wall_ms
                              if busy_ms else None),
        "port_kernels_per_tick": {
            n: {"ms": v[0], "calls": v[1]} for n, v in port.items()}
        if busy_ms else "not measured",
        "kernels": [{"name": n[:120], "ms_per_tick": v[0] / 1e3 / prof_ticks,
                     "calls_per_tick": v[1] / prof_ticks,
                     "share_of_busy": v[0] / 1e3 / busy_ms}
                    for n, v in top] if busy_ms else "not measured",
    }


#: the per-run metrics summarized by median and quartiles
QUARTILE_METRICS = ("step_ms", "tick_ms", "tokens_per_s", "host_ms_per_tick",
                    "overlap_ms_per_tick", "host_work_ms_per_tick",
                    "device_busy_ms_per_step", "device_busy_ms_per_tick",
                    "device_idle_share")


def quartiles(runs, k, metrics, at=50):
    """{metric: the ``at``-th percentile over the runs at multi_tick k}
    ("not measured" where no run has the metric)."""
    out = {}
    for m in metrics:
        vals = [r[m] for r in runs if r["multi_tick"] == k
                and r.get(m) is not None]
        out[m] = float(np.percentile(vals, at)) if vals else "not measured"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("llama", "ernie_moe"),
                    default="llama")
    ap.add_argument("--multi-tick", type=int, nargs="+", default=[1],
                    help="Engine multi_tick values, run in turn")
    ap.add_argument("--pairs", type=int, default=1,
                    help="rounds over the --multi-tick values")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--out", default="chiprun_out/profile_serving")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    model, kw, slots, vocab = build_model(args.config)
    runs = []
    for _ in range(args.pairs):
        for k in args.multi_tick:
            run = profile_run(model, kw, slots, vocab, k, args.steps, out)
            print(json.dumps(run), flush=True)
            runs.append(run)
    medians = {k: quartiles(runs, k, QUARTILE_METRICS, at=50)
               for k in args.multi_tick}
    spread = {k: {q: quartiles(runs, k, QUARTILE_METRICS, at=q)
                  for q in (25, 75)} for k in args.multi_tick}
    result = {"device": card, "config": args.config, "slots": slots,
              "medians": medians, "quartiles": spread, "runs": runs}
    (out / "summary.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"device": card, "config": args.config,
                      "medians": medians}), flush=True)


if __name__ == "__main__":
    main()
