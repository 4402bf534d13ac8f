"""The eager dygraph surface's training loop, and where its host time goes.

    python -m paddle_tpu_torch.profile_eager [--steps 2] [--top 25]

The loop (``chip_smoke.py`` phase 19 builds it from here): the paddle-API
model at BERT-base widths and depth (Embedding -> 12 x
TransformerEncoderLayer -> Linear on the first token), batch 32 x 128
with a key-padding mask, O1 bf16, AdamW 2e-5, dropout 0.1. The profile
builds it on the GPU, runs three warm steps, times five, then runs
``--steps`` steps under ``cProfile`` (the host's Python, by function)
and ``--steps`` under ``torch.profiler`` (CPU ops' self time and the
device kernels' time by name). Prints the card, the step medians, the
top functions and ops, and one JSON line with the totals. Needs a GPU.
"""
from __future__ import annotations

import argparse
import cProfile
import gc
import io
import json
import pstats
import statistics
import subprocess
import time

import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.core import dispatch

#: BERT-base widths and depth, no cut
MODEL = dict(vocab=30522, d_model=768, nhead=12, ffn=3072, layers=12,
             dropout=0.1)
#: one fixed batch [BATCH, SEQ], lengths LEN_LO-SEQ, the first row full
BATCH, SEQ, LEN_LO = 32, 128, 64
#: BERT fine-tuning's learning rate (2e-5 - 5e-5); at 1e-4 the first
#: AdamW step (every parameter moved by ~lr, no warmup) overshoots
LR, WEIGHT_DECAY = 2e-5, 0.01


def build_model(layers=MODEL["layers"], dropout=MODEL["dropout"]):
    """Embedding -> TransformerEncoder -> Linear(d_model, 2), on the
    current place, from the current seed."""
    m = MODEL
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        m["d_model"], m["nhead"], m["ffn"], dropout=dropout,
        activation="gelu"), layers)
    return nn.Sequential(nn.Embedding(m["vocab"], m["d_model"]), enc,
                         nn.Linear(m["d_model"], 2))


def make_optimizer(model, lr=LR):
    return paddle.optimizer.AdamW(learning_rate=lr,
                                  parameters=model.parameters(),
                                  weight_decay=WEIGHT_DECAY)


def fixed_batch(batch=BATCH, seed=11):
    """([ids, keep, labels] as surface Tensors on the current place,
    lengths): ids [batch, SEQ], the bool key mask [batch, 1, 1, SEQ],
    2-class labels, drawn on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, MODEL["vocab"], (batch, SEQ), generator=g)
    lens = torch.randint(LEN_LO, SEQ + 1, (batch,), generator=g)
    lens[0] = SEQ
    keep = (torch.arange(SEQ)[None] < lens[:, None])[:, None, None, :]
    labels = torch.randint(0, 2, (batch,), generator=g)
    return [paddle.to_tensor(t) for t in (ids, keep, labels)], lens


def loss_of(model, ids, keep, labels):
    """The 2-class cross entropy of the first token's output."""
    h = model[1](model[0](ids), src_mask=keep)
    return nn.functional.cross_entropy(model[2](h[:, 0]), labels)


def forward_loss(model, batch):
    """``loss_of`` under ``amp.auto_cast`` O1 bf16."""
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        return loss_of(model, *batch)


def step(model, opt, batch):
    loss = forward_loss(model, batch)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


class GcClock:
    """Seconds the cyclic garbage collector ran while installed (a
    ``gc.callbacks`` hook), and its collections."""

    def __init__(self):
        self.seconds, self.collections, self._t0 = 0.0, 0, None

    def _hook(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.collections += 1
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._hook)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._hook)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_eager needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    paddle.set_device("gpu")
    paddle.seed(0)
    model = build_model()
    opt = make_optimizer(model)
    batch, _ = fixed_batch()
    for _ in range(3):
        step(model, opt, batch)
    torch.cuda.synchronize()
    times, ops = [], []
    with GcClock() as gc_clock:
        for _ in range(5):
            n0, t0 = dispatch.op_count, time.perf_counter()
            step(model, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            ops.append(dispatch.op_count - n0)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(args.steps):
        step(model, opt, batch)
    torch.cuda.synchronize()
    prof.disable()
    cprof_s = time.perf_counter() - t0
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(
        args.top)
    print(out.getvalue(), flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as tp:
        for _ in range(args.steps):
            step(model, opt, batch)
        torch.cuda.synchronize()
    ka = tp.key_averages()
    print(ka.table(sort_by="self_cpu_time_total", row_limit=args.top),
          flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=args.top),
          flush=True)
    # kernels only: an op's row repeats its kernels' device time
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    cpu_us = sum(e.self_cpu_time_total for e in ka)
    med = statistics.median(times)
    print(json.dumps(dict(
        card=card, ms_per_step=med * 1e3, step_ms=[t * 1e3 for t in times],
        surface_ops_per_step=ops[-1],
        host_us_per_surface_op=med * 1e6 / ops[-1],
        gc_ms_per_step=gc_clock.seconds * 1e3 / len(times),
        gc_collections_per_step=gc_clock.collections / len(times),
        gc_tracked_objects=len(gc.get_objects()),
        cprofile_ms_per_step=cprof_s * 1e3 / args.steps,
        profiler_device_ms_per_step=device_us / 1e3 / args.steps,
        profiler_cpu_self_ms_per_step=cpu_us / 1e3 / args.steps,
        device_busy_share=device_us / 1e3 / args.steps / (med * 1e3))),
        flush=True)


if __name__ == "__main__":
    main()
