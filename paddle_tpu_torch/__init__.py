"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside the JAX one (``paddle_tpu/``, the reference it
is held to). It imports ``torch``, never ``jax``, and nothing of
``paddle_tpu``. Plain tensor code is PyTorch; every kernel the JAX
package wrote in Pallas for the TPU is a hand-written CUDA kernel for
Hopper (``csrc/*.cu``, built with ``nvcc`` at first use).

This slice serves LLaMA through the continuous-batching ``Engine``:

    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.inference import Engine, SamplingParams

    model = LlamaForCausalLM(LlamaConfig(num_hidden_layers=4))  # on cuda
    eng = Engine(model, max_slots=16, page_size=128)
    outs = eng.run([(prompt_ids, SamplingParams(max_new_tokens=128))])

Entry points run on ``cuda`` by default and raise when no GPU is
visible; ``device="cpu"`` runs the kernels' plain PyTorch versions.
"""
from . import monitor
from .core.device import resolve_device

__all__ = ["monitor", "resolve_device"]
