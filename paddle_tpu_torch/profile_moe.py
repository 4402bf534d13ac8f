"""The ERNIE-MoE configurations, and where an MoE training step's time
goes on one NVIDIA GPU.

    python -m paddle_tpu_torch.profile_moe [--steps 2] [--out DIR]

The two configurations are defined here once (``chip_smoke.py`` imports
them), with random weights drawn from a seed:

- training, ``bench.py::bench_ernie_moe``: vocab 32000, hidden 1024,
  expert FFN 2816, 8 layers (4 MoE, ``moe_every=2``), 16 heads, 8
  experts, top-2 GShard routing, capacity factor 2.0; batch 32 x seq 512;
  ``CrossEntropyLoss + aux_loss``; ``AdamW(1e-4, bf16 moments)`` in
  ``TrainStep(amp_dtype="bfloat16")``;
- serving, ``bench.py::bench_ernie_moe_serving``: the same widths at 4
  layers (2 MoE), f32 weights, an ``Engine`` with 8 slots, 128-token
  pages, a 64-token prefill bucket, and 16 requests of 64-191 prompt
  tokens and 96 new tokens each (the bench's prompts: same generator, same
  draws).

The profile builds the training configuration and runs
``profile_training.profile_step`` on it: two warm-up steps, ``--steps``
steps timed without the profiler, ``--steps`` more under
``torch.profiler`` summed by kind (the grouped-FFN and flash kernels of
the port, cuBLAS GEMMs, elementwise, copies and casts, reductions) with
the device idle share, and the AdamW update timed alone on both routes.
Prints one JSON line and writes it, with the chrome trace, to ``--out``
(default chiprun_out/profile_moe). Needs a GPU: it raises otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from .jit import TrainStep
from .nn._modules import CrossEntropyLoss
from .optimizer import AdamW
from .profile_training import fixed_batch, parse_args, profile_step
from .text.models import ErnieMoEConfig, ErnieMoEForCausalLM

_WIDTHS = dict(vocab_size=32000, hidden_size=1024, intermediate_size=2816,
               num_attention_heads=16, num_key_value_heads=16, num_experts=8,
               moe_every=2)
#: the training configuration (bench.py::bench_ernie_moe)
MOE_TRAIN_MODEL = dict(_WIDTHS, num_hidden_layers=8,
                       max_position_embeddings=512)
MOE_BATCH, MOE_SEQ, MOE_LR = 32, 512, 1e-4
#: the serving configuration (bench.py::bench_ernie_moe_serving)
MOE_REQUESTS, MOE_PROMPT_LO, MOE_PROMPT_HI, MOE_NEW_TOKENS = 16, 64, 192, 96
MOE_SERVE_MODEL = dict(_WIDTHS, num_hidden_layers=4,
                       max_position_embeddings=MOE_PROMPT_HI + MOE_NEW_TOKENS)
MOE_ENGINE = dict(max_slots=8, page_size=128, prefill_bucket=64,
                  max_context=MOE_PROMPT_HI + MOE_NEW_TOKENS)


def moe_train_step(model):
    """The training step of the configuration: ``CrossEntropyLoss +
    aux_loss`` under bf16 O2 AMP, AdamW(1e-4) with bf16 moments."""
    ce = CrossEntropyLoss()
    opt = AdamW(MOE_LR, parameters=model.parameters(),
                moment_dtype="bfloat16")
    return TrainStep(model, lambda out, lab: ce(out, lab) + model.aux_loss(),
                     opt, amp_dtype="bfloat16")


def moe_prompts(vocab_size, seed=0):
    """The serving bench's 16 prompts: its generator's arrival draws first,
    then the prompt lengths and tokens."""
    rng = np.random.default_rng(seed)
    rng.exponential(1.0 / 40.0, MOE_REQUESTS)        # the bench's arrivals
    return [rng.integers(0, vocab_size, (int(rng.integers(
        MOE_PROMPT_LO, MOE_PROMPT_HI)),)).astype(np.int64)
        for _ in range(MOE_REQUESTS)]


def main(argv=None):
    args = parse_args(argv, "chiprun_out/profile_moe")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = ErnieMoEForCausalLM(ErnieMoEConfig(**MOE_TRAIN_MODEL), seed=0)
    ids, labels = fixed_batch(MOE_TRAIN_MODEL["vocab_size"], MOE_BATCH,
                              MOE_SEQ, model.device)
    profile_step(moe_train_step(model), ids, labels, args,
                 dict(batch=MOE_BATCH, seq=MOE_SEQ))


if __name__ == "__main__":
    main()
