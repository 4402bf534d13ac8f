"""Two checkouts' serving decode-tick kernel wrappers, timed in turns on
one NVIDIA GPU.

    python paddle_tpu_torch/ab_serving_kernels.py --roots OLD NEW
        [--pairs 10] [--serving-pairs 0] [--out FILE]

Runs itself once per checkout root in a fresh process that imports
``paddle_tpu_torch`` from that root (whose kernels are built under the
root's ``build/``), ``--pairs`` times each, in the order OLD NEW NEW OLD
OLD NEW ... so that neither root always runs first. Each run draws its
inputs from a seed and times three wrappers of a serving decode tick:

- ``paged_decode`` at the LLaMA serving geometry (16 slots, h = h_kv =
  32, d 128, bf16 pool, contexts up to 320 with two dead slots) and at
  the ERNIE-MoE one (8 slots, h = h_kv = 16, d 64, f32 pool, contexts up
  to 287 with a dead slot), 128-token pages, 3 a slot, f32 q;
- ``grouped_ffn_fwd`` at the ERNIE-MoE decode tick (f32, 8 experts,
  capacity 8, h 1024, dff 2816, counts 2 3 0 1 4 2 2 2).

Each gets three times:

- ``host_us``: the host's microseconds a call, the wall time of issuing
  100 calls back to back without waiting for the device (fewer launches
  than the launch queue holds), the median of 5 such runs;
- ``event_ms``: CUDA events around 20 eager calls after 3 (host and
  device, whichever is slower, a call);
- ``graph_ms``: the device's ms a call, from a CUDA graph of 20 wrapper
  calls replayed 5 times, cycling through copies of the pools (or
  weights) that together hold at least twice the L2 of live bytes, so a
  call reads HBM and not the last call's lines.

A root that has ``_build.stream`` also reports the host microseconds of
reading the current stream's handle through
``torch.cuda.current_stream(device).cuda_stream`` and through
``_build.stream(device)``.

With ``--serving-pairs N`` it then runs ``python -m
paddle_tpu_torch.profile_serving`` (the LLaMA Engine, 16 slots) in each
root N times in the same alternating order and keeps its ``step_ms``,
``tokens_per_s``, ``device_busy_ms_per_step`` and, where the root's
profile reports it, ``port_kernels`` (device ms a step of paged
decode).

Prints one JSON line per run, then a summary line: for every measure
each root's median, the median of the pairs' differences (NEW - OLD),
the pairs in which NEW reads lower and OLD's interquartile spread;
writes all of it to ``--out`` (default
chiprun_out/ab_serving_kernels.json). Needs a GPU.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
#: (slots, heads, kv heads, head dim, pool dtype, longest context, dead)
PAGED = {"llama": (16, 32, 32, 128, "bfloat16", 320, (3, 11)),
         "ernie_moe": (8, 16, 16, 64, "float32", 287, (3,))}
PAGE, PAGES = 128, 3
#: the ERNIE-MoE decode tick's grouped-FFN forward: E, C, h, dff, counts
FFN = (8, 8, 1024, 2816, (2, 3, 0, 1, 4, 2, 2, 2))


def _host_us(torch, fn, calls=100, reps=5):
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return statistics.median(times)


def _event_ms(torch, fn, iters=20, warmup=3):
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


def _graph_ms(torch, fn, calls=20, reps=5):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    gc.disable()                # a collection would fail the capture
    try:
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
    finally:
        gc.enable()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (reps * calls)


def cold_copies(torch, tensors, live_bytes):
    """``tensors`` (None entries kept as None) and enough clones of them
    that a walk through the copies reads at least twice the card's L2
    of live bytes before it returns to the first: a CUDA graph cycling
    through them times a kernel's reads from HBM, not from an L2 that
    still holds the last call's lines (chip_smoke.py uses it too)."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 * 2 ** 20)
    n = max(1, -(-2 * l2 // max(live_bytes, 1)))
    return [tuple(tensors)] + [
        tuple(None if t is None else t.clone() for t in tensors)
        for _ in range(n - 1)]


def _times(torch, call, sets):
    """host_us, event_ms (on the first set) and graph_ms (cycling)."""
    walk = iter(range(10 ** 9))
    rec = dict(host_us=_host_us(torch, lambda: call(*sets[0])),
               event_ms=_event_ms(torch, lambda: call(*sets[0])))
    rec["graph_ms"] = _graph_ms(
        torch, lambda: call(*sets[next(walk) % len(sets)]))
    rec["copies"] = len(sets)
    return rec


def child():
    import torch
    from paddle_tpu_torch.kernels import _build, moe
    from paddle_tpu_torch.kernels import paged_attention as pa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {}
    for geo, (b, h, hkv, d, dt, longest, dead) in PAGED.items():
        dt = getattr(torch, dt)
        ctx = torch.randint(1, longest + 1, (b,), generator=g, device=dev)
        ctx[0] = longest
        for s in dead:
            ctx[s] = 0
        ctx = ctx.to(torch.int32)
        nb = b * PAGES + 1
        bt = (torch.randperm(nb - 1, generator=g, device=dev) + 1).reshape(
            b, PAGES).to(torch.int32)
        q = torch.randn(b, h, d, generator=g, device=dev)
        k = torch.randn(nb, hkv, PAGE, d, generator=g, device=dev).to(dt)
        v = torch.randn(nb, hkv, PAGE, d, generator=g, device=dev).to(dt)
        live = int(ctx.clamp(max=PAGES * PAGE).sum())
        sets = cold_copies(torch, (k, v),
                           2 * live * hkv * d * k.element_size())
        res[f"paged_decode_{geo}"] = _times(
            torch, lambda k_, v_: pa.paged_decode(q, k_, v_, bt, ctx), sets)
        del sets, k, v
    E, C, h, dff, counts = FFN
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev)

    def r(*shape, sc=1.0):
        return torch.randn(*shape, generator=g, device=dev) * sc
    x, b1, b2 = r(E, C, h, sc=0.5), r(E, 1, dff, sc=0.1), r(E, 1, h, sc=0.1)
    ws = torch.rand(E, C, 1, generator=g, device=dev)
    w1, w2 = r(E, h, dff, sc=h ** -0.5), r(E, dff, h, sc=dff ** -0.5)
    live = sum(c > 0 for c in counts) * 2 * h * dff * 4
    sets = cold_copies(torch, (w1, w2), live)
    res["grouped_ffn_fwd_decode_f32"] = _times(
        torch, lambda w1_, w2_: moe.grouped_ffn_fwd(x, w1_, b1, w2_, b2, ws,
                                                    cnt), sets)
    if hasattr(_build, "stream"):
        res["stream_handle_us"] = {
            "torch.cuda.current_stream": _host_us(
                torch, lambda: torch.cuda.current_stream(dev).cuda_stream,
                calls=1000),
            "_build.stream": _host_us(
                torch, lambda: _build.stream(dev), calls=1000)}
    print(json.dumps(res), flush=True)


def _run(root, argv):
    env = dict(os.environ, PYTHONPATH=str(root))
    p = subprocess.run([sys.executable] + argv, cwd=root, env=env,
                       capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        raise RuntimeError(f"{argv} in {root} failed (rc {p.returncode}):"
                           f"\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def _order(roots, pairs):
    old, new = roots
    return [r for i in range(pairs)
            for r in ((old, new) if i % 2 == 0 else (new, old))]


def _flat(rec, prefix=""):
    out = {}
    for k, v in rec.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[prefix + k] = v
    return out


def _summary(runs, roots):
    """Each measure: the median of each root's runs, the median of the
    pairs' differences (NEW - OLD, pairs taken in run order), the pairs
    in which NEW reads lower, and the spread of OLD's own runs (the
    distance between their quartiles)."""
    old, new = (str(r) for r in roots)
    by = {old: [], new: []}
    for root, rec in runs:
        by[root].append(_flat(rec))
    keys = sorted(set(by[old][0]) & set(by[new][0]))
    out = {}
    for k in keys:
        a, b = [r[k] for r in by[old]], [r[k] for r in by[new]]
        q = statistics.quantiles(a, n=4) if len(a) > 1 else [a[0]] * 3
        out[k] = {"old": statistics.median(a), "new": statistics.median(b),
                  "new_minus_old": statistics.median(
                      y - x for x, y in zip(a, b)),
                  "new_lower_in": f"{sum(y < x for x, y in zip(a, b))} of "
                                  f"{min(len(a), len(b))} pairs",
                  "old_iqr": q[2] - q[0]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs=2, required=True)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--serving-pairs", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/ab_serving_kernels.json")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        # the package comes from the root (PYTHONPATH), never from this
        # file's directory
        here = Path(__file__).resolve().parent
        sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
        return child()
    roots = [Path(r).resolve() for r in args.roots]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    me = str(Path(__file__).resolve())
    report = {"device": card, "roots": [str(r) for r in roots]}
    runs = []
    for root in _order(roots, args.pairs):
        rec = _run(root, [me, "--roots", *args.roots, "--child"])
        runs.append((str(root), rec))
        print(json.dumps({"root": str(root), **rec}), flush=True)
    report["kernels"] = {"runs": runs, "summary": _summary(runs, roots)}
    if args.serving_pairs:
        serving = []
        for root in _order(roots, args.serving_pairs):
            rec = _run(root, ["-m", "paddle_tpu_torch.profile_serving",
                              "--out", str(root / "build" / "ab_profile")])
            # a tree whose profile_serving reports medians by multi_tick
            rec = rec["medians"]["1"] if "medians" in rec else rec
            keep = {k: rec[k] for k in ("step_ms", "tokens_per_s",
                                        "device_busy_ms_per_step",
                                        "port_kernels") if k in rec}
            serving.append((str(root), keep))
            print(json.dumps({"root": str(root), **keep}), flush=True)
        report["serving"] = {"runs": serving,
                             "summary": _summary(serving, roots)}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k]["summary"] for k in ("kernels", "serving")
                      if k in report}), flush=True)


if __name__ == "__main__":
    main()
