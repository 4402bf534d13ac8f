"""The BERT encoder configurations, and where a BERT training step's time
goes on one NVIDIA GPU.

    python -m paddle_tpu_torch.profile_encoder [--steps 2] [--out DIR]

The two configurations are defined here once (``chip_smoke.py`` imports
them), with random weights drawn from a seed:

- serving, ``BERT_EMBED`` (``bench.py::bench_bert_embedding``): BERT-base
  (vocab 30522, hidden 768, 12 layers, 12 heads, FFN 3072, 512
  positions), f32 weights, eval mode; a ``BatchEncoder`` with
  ``max_batch=16`` and ``bucket=32`` serving 64 requests of 16-127
  tokens arriving at 400 Hz (Poisson, ``default_rng(0)``), pooling
  alternating CLS / mean (the bench's draws: same generator, same order);
- training, ``BERT_TRAIN`` (``bench.py::bench_bert``): ``BertForPretraining``
  at BERT-base widths, batch 256 x seq 128, int32 ids, zero token types,
  ``CrossEntropyLoss`` on the dense MLM logits, ``AdamW(1e-4, bf16
  moments)`` in ``TrainStep(amp_dtype="bfloat16")``, dropout 0.1 active.

The profile builds the training configuration and runs
``profile_training.profile_step`` on it: two warm-up steps, ``--steps``
steps timed without the profiler, ``--steps`` more under
``torch.profiler`` summed by kind (the port's flash kernels, cuBLAS
GEMMs, elementwise, copies and casts, reductions) with the device idle
share, and the AdamW update timed alone on both routes. Prints one JSON
line and writes it, with the chrome trace, to ``--out`` (default
chiprun_out/profile_encoder). Needs a GPU: it raises otherwise.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .inference import EmbedParams
from .jit import TrainStep
from .nn._modules import CrossEntropyLoss
from .optimizer import AdamW
from .profile_training import parse_args, profile_step
from .text.models import BertConfig, BertForPretraining

#: BERT-base, the position table at 512 (both benches' max(512, seq))
_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
             num_attention_heads=12, intermediate_size=3072,
             max_position_embeddings=512)
#: the serving configuration (bench.py::bench_bert_embedding)
BERT_EMBED = dict(model=_BASE, max_batch=16, bucket=32, n_requests=64,
                  seq_lo=16, seq_hi=128, arrival_rate_hz=400.0, seed=0)
#: the training configuration (bench.py::bench_bert)
BERT_TRAIN = dict(model=_BASE, batch=256, seq=128, lr=1e-4, seed=0)


def bert_flops_per_token(model) -> float:
    """``bench_bert``'s 6N rule: 6 x the parameter count per token."""
    return 6.0 * sum(p.numel() for p in model.parameters())


def embed_trace(vocab_size, cfg=BERT_EMBED):
    """The serving bench's trace: arrival times (s, cumulative), token id
    arrays and pooling modes, drawn as ``bench_bert_embedding`` draws
    them."""
    rng = np.random.default_rng(cfg["seed"])
    n = cfg["n_requests"]
    arrivals = np.cumsum(rng.exponential(1.0 / cfg["arrival_rate_hz"], n))
    seqs = [rng.integers(0, vocab_size, (int(rng.integers(
        cfg["seq_lo"], cfg["seq_hi"])),)).astype(np.int64)
        for _ in range(n)]
    pools = ["mean" if i % 2 else "cls" for i in range(n)]
    return arrivals, seqs, pools


def run_embed_trace(svc, trace):
    """Replay ``trace`` against ``svc`` on the wall clock, as the bench
    does: requests are queued once their arrival time has passed, and an
    idle service sleeps until the next arrival. Returns {"outs",
    "seconds", "steps", "host_ms", "device_ms"}: the outputs, the wall
    time, and the steps with their host and device ms summed (the
    service's ``serving.embed.{host,device}_ms_per_tick`` gauges). The
    wall time cannot end before the last arrival, so tokens over it
    mostly read the trace's arrival rate; device ms per batch is what
    kernel work moves. How many batches a pass takes depends on when the
    steps fall between arrivals, so it varies from run to run."""
    from . import monitor
    arrivals, seqs, pools = trace
    n = len(seqs)
    res = dict(outs=[], steps=0, host_ms=0.0, device_ms=0.0)
    t0 = time.perf_counter()
    i = 0
    while len(res["outs"]) < n:
        now = time.perf_counter() - t0
        while i < n and arrivals[i] <= now:
            svc.add_request(seqs[i], EmbedParams(pooling=pools[i]))
            i += 1
        if i < n and svc.idle:
            time.sleep(max(0.0, arrivals[i] - (time.perf_counter() - t0)))
            continue
        res["outs"].extend(svc.step())
        res["steps"] += 1
        res["host_ms"] += monitor.gauge(
            "serving.embed.host_ms_per_tick").get()
        res["device_ms"] += monitor.gauge(
            "serving.embed.device_ms_per_tick").get()
    res["seconds"] = time.perf_counter() - t0
    return res


def bert_train_step(model, cfg=BERT_TRAIN):
    """The training step of the configuration: CE on the dense MLM logits
    under bf16 O2 AMP, AdamW with bf16 moments."""
    ce = CrossEntropyLoss()
    opt = AdamW(cfg["lr"], parameters=model.parameters(),
                moment_dtype="bfloat16")
    return TrainStep(model, lambda out, lab: ce(out[0], lab), opt,
                     amp_dtype="bfloat16")


def train_batch(vocab_size, device, cfg=BERT_TRAIN):
    """((ids, token types), labels): int32 ids and labels drawn from seed
    4, zero token types."""
    gen = torch.Generator(device=device).manual_seed(4)
    shape = (cfg["batch"], cfg["seq"])
    ids, labels = (torch.randint(0, vocab_size, shape, generator=gen,
                                 device=device, dtype=torch.int32)
                   for _ in range(2))
    return (ids, torch.zeros_like(ids)), labels


def main(argv=None):
    args = parse_args(argv, "chiprun_out/profile_encoder")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = BertForPretraining(BertConfig(**BERT_TRAIN["model"]),
                               seed=BERT_TRAIN["seed"])
    inputs, labels = train_batch(BERT_TRAIN["model"]["vocab_size"],
                                 model.device)
    profile_step(bert_train_step(model), inputs, labels, args,
                 dict(batch=BERT_TRAIN["batch"], seq=BERT_TRAIN["seq"]))


if __name__ == "__main__":
    main()
