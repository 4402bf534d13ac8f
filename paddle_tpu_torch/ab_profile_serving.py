"""Two trees' serving steps side by side, on one NVIDIA GPU.

    python -m paddle_tpu_torch.ab_profile_serving --roots build/parent . \\
        [--configs llama ernie_moe] [--multi-tick 8 1] [--pairs 10] \\
        [--rounds 1]

Runs ``python -m paddle_tpu_torch.profile_serving`` of each root (a
checkout of the repository; the parent unpacked with ``git archive``
into a git-ignored directory) in turns, one process a run: each round
takes every configuration, the roots' order alternating between
configurations and between rounds (round 0: A B, B A; round 1: B A,
A B), so over two rounds each root runs first once a configuration.
Prints, by root, configuration and k, the median and quartiles over all
its processes' runs of:

- ``host_work_ms_per_tick``: the host's own work a device tick, the
  step's wall time less its blocking waits — the engine's host ms a tick
  plus its overlap ms where the tree reports overlap, its host ms a tick
  where it does not (an engine without windowed attribution books all
  of it as host time);
- ``host_ms_per_tick``, ``overlap_ms_per_tick`` as each tree reports
  them, ``tick_ms`` and ``tokens_per_s``.

Writes the summary to ``--out`` (default chiprun_out/ab_profile_serving)
and deletes the profiles' chrome traces (their size). Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

METRICS = ("host_work_ms_per_tick", "host_ms_per_tick", "overlap_ms_per_tick",
           "tick_ms", "tokens_per_s")


def _host_work(run):
    if "host_work_ms_per_tick" in run:
        return run["host_work_ms_per_tick"]
    return run["host_ms_per_tick"]


def summarize(runs, ks):
    """{k: {metric: {p25, median, p75, n}}} over one tree's runs."""
    out = {}
    for k in ks:
        at = [r for r in runs if r["multi_tick"] == k]
        vals = {"host_work_ms_per_tick": [_host_work(r) for r in at]}
        for m in METRICS[1:]:
            vals[m] = [r[m] for r in at if r.get(m) is not None]
        out[k] = {m: {"p25": float(np.percentile(v, 25)),
                      "median": float(np.median(v)),
                      "p75": float(np.percentile(v, 75)), "n": len(v)}
                  for m, v in vals.items() if v}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs=2, required=True,
                    help="two repository checkouts (A B)")
    ap.add_argument("--configs", nargs="+", default=["llama", "ernie_moe"])
    ap.add_argument("--multi-tick", type=int, nargs="+", default=[8, 1])
    ap.add_argument("--pairs", type=int, default=10,
                    help="profile_serving's --pairs (runs a process)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="processes a root and configuration")
    ap.add_argument("--out", default="chiprun_out/ab_profile_serving")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    roots = [str(Path(r).resolve()) for r in args.roots]
    runs = {(c, r): [] for c in args.configs for r in args.roots}
    device = None
    for rnd in range(args.rounds):
        for ci, config in enumerate(args.configs):
            order = roots if (rnd + ci) % 2 == 0 else roots[::-1]
            for root in order:
                name = args.roots[roots.index(root)]
                tag = "a" if root == roots[0] else "b"
                run_out = out / f"{config}_{tag}_{rnd}"
                cmd = [sys.executable, "-m",
                       "paddle_tpu_torch.profile_serving", "--config",
                       config, "--pairs", str(args.pairs), "--out",
                       str(run_out), "--multi-tick",
                       *map(str, args.multi_tick)]
                env = dict(os.environ, PYTHONPATH=root)
                subprocess.run(cmd, cwd=root, env=env, check=True)
                summary = json.loads((run_out / "summary.json").read_text())
                (run_out / "trace.json").unlink(missing_ok=True)
                device = summary["device"]
                runs[(config, name)] += summary["runs"]
    result = {"roots": args.roots, "multi_tick": args.multi_tick,
              "pairs": args.pairs, "rounds": args.rounds, "device": device,
              "configs": {c: {r: summarize(runs[(c, r)], args.multi_tick)
                              for r in args.roots} for c in args.configs}}
    (out / "summary.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
