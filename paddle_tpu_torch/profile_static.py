"""The compile of ``jit.to_static``'s BERT-base training entry, and where
its time goes.

    python -m paddle_tpu_torch.profile_static [--dropout 0.1]
        [--fallback-random] [--cprofile] [--top 30] [--out DIR]

The entry is ``chip_smoke.py`` phase 27 (b)'s: ``profile_eager``'s model
(BERT-base widths and depth, batch 32 x 128, key mask), its forward and
loss through ``paddle.jit.to_static`` (Inductor) under O1 bf16. The
profile runs the first call and its backward (the compile) with
Inductor's and Triton's caches in a fresh directory under ``build/``,
under ``cProfile``
with ``--cprofile``, then times a steady step. Prints the card, Dynamo's
``compile_times`` of the compile, with ``--cprofile`` the top functions
by cumulative and by own time, and one JSON line with the seconds;
``--out`` keeps the full tables. ``--fallback-random`` sets Inductor's
``fallback_random`` (the random ops as aten calls, not Inductor's own
generator). Needs a GPU.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import tempfile
import time
from pathlib import Path


def _stats(prof, key, top):
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(top)
    return buf.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--fallback-random", action="store_true")
    ap.add_argument("--cprofile", action="store_true")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    build = Path(__file__).resolve().parent.parent / "build"
    build.mkdir(exist_ok=True)
    cache = tempfile.mkdtemp(prefix="profile_static_", dir=build)
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")

    import torch
    import torch._inductor.config as inductor_config
    from torch._dynamo.utils import compile_times

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import profile_eager as ep

    if not torch.cuda.is_available():
        raise SystemExit("profile_static needs a GPU")
    inductor_config.fallback_random = args.fallback_random
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    paddle.set_device("gpu")
    paddle.seed(0)
    model = ep.build_model(ep.MODEL["layers"], args.dropout)
    batch, _ = ep.fixed_batch()
    fn = paddle.jit.to_static(
        lambda ids, keep, labels: ep.loss_of(model, ids, keep, labels))

    def step():
        t0 = time.perf_counter()
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = fn(*batch)
        loss.backward()
        for p in model.parameters():
            p.clear_gradient()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prof = cProfile.Profile() if args.cprofile else None
    if prof:
        prof.enable()
    first_s = step()
    if prof:
        prof.disable()
    steady_s = min(step() for _ in range(3))
    times = compile_times(repr="str")
    print(times)
    if prof:
        print(_stats(prof, "cumulative", args.top))
        print(_stats(prof, "tottime", args.top))
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        tag = f"dropout{args.dropout}" + (
            "_fallback_random" if args.fallback_random else "") + (
            "_cprofile" if prof else "")
        (out / f"compile_times_{tag}.txt").write_text(times)
        if prof:
            (out / f"cprofile_{tag}.txt").write_text(
                _stats(prof, "cumulative", 200)
                + _stats(prof, "tottime", 200))
    print(json.dumps(dict(card=card, dropout=args.dropout,
                          fallback_random=args.fallback_random,
                          first_call_s=first_s, steady_step_s=steady_s,
                          compile_s=first_s - steady_s)), flush=True)


if __name__ == "__main__":
    main()
