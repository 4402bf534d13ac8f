"""Where a training step's time goes, on one NVIDIA GPU.

    python -m paddle_tpu_torch.profile_training [--steps 2] [--out DIR]

Builds the training configuration chip_smoke.py drives (the JAX
package's ``bench.py::bench_llama_1b``: vocab 32000, hidden 4096, ff
11008, 32 heads, 4 layers, fused 4-chunk LM loss, f32 weights drawn from
a seed; batch 12 x seq 1024; TrainStep(amp_dtype="bfloat16") with
AdamW(3e-4, bf16 moments)) and profiles it with ``profile_step`` (which
``profile_moe`` shares): two warm-up steps, then

1. times ``--steps`` steps without the profiler (host clock around
   steps ending in a synchronize): ms per step and tokens/s;
2. records ``--steps`` more under ``torch.profiler`` (CPU + CUDA) and
   sums the device kernels of the exported trace: device-busy ms per
   step, the device idle share of the window, the kernels by device time
   and their sums by kind (the port's flash kernels, cuBLAS GEMMs,
   elementwise, copies and casts, reductions);
3. times parts of a step alone with CUDA events: the AdamW update of
   every parameter on both routes in turns, the step's own
   (``apply_gradients_pytree``: one fused launch, ``csrc/fused_adam.cu``)
   as ``optimizer_update_ms`` and the per-tensor plain rule the port ran
   before it (``plain_update``) as ``optimizer_update_plain_ms``, each
   the median of ``UPDATE_PAIRS`` pairs; and the bf16 cast of the parameters
   for the forward.

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
from .optimizer import AdamW, Optimizer
from .profile_serving import _kernel_times
from .text.models import LlamaConfig, LlamaForCausalLM

#: the training configuration, bench.py::bench_llama_1b's (chip_smoke.py
#: imports it too)
MODEL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
             num_hidden_layers=4, num_attention_heads=32,
             num_key_value_heads=32, max_position_embeddings=1024,
             fused_linear_ce=True, fused_ce_chunks=4)
BATCH, SEQ = 12, 1024
#: fused / plain update timings, taken in turns (``update_ms``)
UPDATE_PAIRS = 3


def _kind(name):
    for key, kind in (("grouped_ffn_fwd", "grouped FFN forward (port)"),
                      ("grouped_ffn_dx", "grouped FFN dx (port)"),
                      ("grouped_ffn_dw", "grouped FFN dw (port)"),
                      ("grouped_ffn_db1", "grouped FFN dw (port)"),
                      ("flash_bwd_dkv", "flash dK/dV (port)"),
                      ("flash_bwd_dq", "flash dQ (port)"),
                      ("flash_fwd", "flash forward (port)"),
                      ("fused_adam", "fused Adam update (port)"),
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


def parse_args(argv, default_out):
    ap = argparse.ArgumentParser(
        description="where a training step's time goes, on one GPU")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=default_out)
    return ap.parse_args(argv)


@torch.no_grad()
def plain_update(opt, params, grads, state, lr):
    """The optimizer's per-tensor rule over every parameter, one at a
    time (``Optimizer._apply_updates``): the update the port ran before
    the fused kernel, timed beside it."""
    items = [(p, grads[n], state[n], p.dtype) for n, p in params.items()]
    Optimizer._apply_updates(opt, items, lr, opt._weight_decay)


def update_ms(step):
    """(fused ms, plain ms): the update of every parameter of ``step`` (a
    ``TrainStep``) from zero gradients, the step's own route
    (``apply_gradients_pytree``) and the plain rule in turns, the median
    of ``UPDATE_PAIRS`` each. Moves the weights and the optimizer
    state."""
    opt, params, state = step._opt, step._params, step.opt_state
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    lr = opt.get_lr()
    fused, plain = [], []
    for _ in range(UPDATE_PAIRS):
        fused.append(_device_ms(lambda: opt.apply_gradients_pytree(
            params, zeros, state, lr)))
        plain.append(_device_ms(lambda: plain_update(opt, params, zeros,
                                                     state, lr)))
    return sorted(fused)[UPDATE_PAIRS // 2], sorted(plain)[UPDATE_PAIRS // 2]


def fixed_batch(vocab_size, batch, seq, device):
    """The profiled batch: token ids and labels drawn from seed 4."""
    gen = torch.Generator(device=device).manual_seed(4)
    return tuple(torch.randint(0, vocab_size, (batch, seq), generator=gen,
                               device=device) for _ in range(2))


def profile_step(step, inputs, labels, args, meta, extra_parts=None):
    """Profile ``step(inputs, labels)`` (a ``TrainStep``) on one fixed
    batch: two warm-up steps, then items 1-3 of the module docstring, with
    ``extra_parts`` ({result key: fn(params)}) timed after the AdamW
    update. ``meta`` (``batch``, ``seq``, ...) heads the result. Writes
    the result and the chrome trace to ``args.out``, prints the result as
    one JSON line and returns it."""
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    def run(n):
        for _ in range(n):
            step(inputs, labels)
        torch.cuda.synchronize()
    run(2)                                        # warm up

    t0 = time.perf_counter()
    run(args.steps)
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    trace = out / "trace.json"
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        run(args.steps)
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    prof.export_chrome_trace(str(trace))
    per, _ = _kernel_times(trace)
    busy_ms = sum(v[0] for v in per.values()) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:20]
    kinds = {}
    for n, (us, _) in per.items():
        kinds[_kind(n)] = kinds.get(_kind(n), 0.0) + us / 1e3 / args.steps
    # the parts of a step timed alone (these move the weights: last)
    params = step._params
    fused_ms, plain_ms = update_ms(step)
    parts = {"optimizer_update_ms": fused_ms,
             "optimizer_update_plain_ms": plain_ms}
    for key, fn in (extra_parts or {}).items():
        parts[key] = _device_ms(lambda fn=fn: fn(params))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    result = {
        "device": card, **meta, "steps": args.steps, "step_ms": step_ms,
        "tokens_per_s": meta["batch"] * meta["seq"] * 1e3 / step_ms,
        "profiled_step_ms": prof_wall_ms / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": (1.0 - busy_ms / prof_wall_ms
                              if busy_ms else None),
        **parts,
        "ms_per_step_by_kind": dict(sorted(kinds.items(),
                                           key=lambda kv: -kv[1])),
        "kernels": [{"name": n[:120], "ms_per_step": v[0] / 1e3 / args.steps,
                     "calls_per_step": v[1] / args.steps,
                     "share_of_busy": v[0] / 1e3 / busy_ms}
                    for n, v in top] if busy_ms else "not measured",
    }
    (out / "summary.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    args = parse_args(argv, "chiprun_out/profile_training")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaForCausalLM(LlamaConfig(**MODEL), seed=0)
    opt = AdamW(3e-4, parameters=model.parameters(), moment_dtype="bfloat16")
    step = TrainStep(model, lambda o, lab: o, opt, amp_dtype="bfloat16")
    ids, labels = fixed_batch(MODEL["vocab_size"], BATCH, SEQ, model.device)
    profile_step(step, (ids, labels), labels, args,
                 dict(batch=BATCH, seq=SEQ),
                 {"amp_cast_ms": lambda params: [p.to(torch.bfloat16)
                                                 for p in params.values()]})


if __name__ == "__main__":
    main()
