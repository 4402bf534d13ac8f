"""Weight bridge: JAX-package parameters and optimizer state -> the
port's, and back.

The JAX package names parameters as ``paddle_tpu.jit.functional.
get_params`` gives them (``llama.layers.0.self_attn.q_proj.weight``,
``layers.1.mlp.experts.w1``, ...), and the port's modules carry the same
names. The one layout
difference: a paddle Linear weight is [in, out], a ``torch.nn.Linear``
weight is [out, in], so every 2-D weight of a Linear is transposed.
Embedding ([vocab, hidden]) and norm parameters cross as they are. Adam
state ({name: {moment1, moment2[, moment2_max], beta1_pow, beta2_pow}},
the JAX ``TrainStep``'s ``_opt_state``) crosses the same way: a Linear's
moments are transposed like its weight, the scalars cross as they are.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: parameter-name suffixes of Linear weights (transposed on the way in):
#: LLaMA's and ERNIE-MoE's projections and head, BERT's qkv, out, fc1,
#: fc2, pooler, transform and nsp_head
LINEAR_SUFFIXES = ("_proj.weight", "lm_head.weight", ".qkv.weight",
                   ".out.weight", ".fc1.weight", ".fc2.weight",
                   "pooler.weight", "transform.weight", "nsp_head.weight")


def llama_state_from_numpy(params: Dict[str, np.ndarray]
                           ) -> Dict[str, torch.Tensor]:
    """{name: array} in the JAX package's layout -> a state_dict for
    ``paddle_tpu_torch.text.models.LlamaForCausalLM.load_state_dict``."""
    out = {}
    for name, arr in params.items():
        a = np.asarray(arr)
        if name.endswith(LINEAR_SUFFIXES):
            if a.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D Linear weight, "
                                 f"got shape {a.shape}")
            a = a.T
        out[name] = torch.tensor(np.ascontiguousarray(a))
    return out


def llama_state_to_numpy(state: Dict[str, torch.Tensor]
                         ) -> Dict[str, np.ndarray]:
    """The inverse of llama_state_from_numpy: a port state_dict -> {name:
    array} in the JAX package's layout."""
    out = {}
    for name, t in state.items():
        a = t.detach().cpu().numpy()
        out[name] = np.ascontiguousarray(
            a.T if name.endswith(LINEAR_SUFFIXES) else a)
    return out


#: ERNIE-MoE crosses by the same rule: its ``*_proj.weight`` and
#: ``lm_head.weight`` are transposed, and the MoE blocks' raw parameters
#: (``gate_weight`` [h, E], ``experts.w1`` [E, h, dff], ``b1`` [E, 1, dff],
#: ``w2``, ``b2``) are kept in the JAX layout by the port and cross as they
#: are — so the Adam state bridge below holds for MoE unchanged.
ernie_moe_state_from_numpy = llama_state_from_numpy
ernie_moe_state_to_numpy = llama_state_to_numpy


#: BERT crosses by the same rule: its Linear weights are transposed, the
#: embeddings and LayerNorm parameters cross as they are, and the MLM
#: decoder is the word embedding itself (one parameter, crossed once). The
#: Adam state bridge below holds for BERT unchanged.
bert_state_from_numpy = llama_state_from_numpy
bert_state_to_numpy = llama_state_to_numpy


def _numpy_of(t):
    if t.dtype == torch.bfloat16:        # numpy has no bfloat16
        t = t.float()
    return t.detach().cpu().numpy()


def adam_state_from_numpy(state: Dict[str, Dict[str, np.ndarray]],
                          device=None, moment_dtype=None
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's Adam/AdamW state (``TrainStep._opt_state``, as
    numpy) -> the port's ``TrainStep.opt_state`` layout, moments in
    ``moment_dtype`` (default: as given)."""
    out = {}
    for name, slots in state.items():
        lin = name.endswith(LINEAR_SUFFIXES)
        out[name] = {}
        for slot, arr in slots.items():
            a = np.asarray(arr, np.float32)
            if lin and slot.startswith("moment"):
                a = a.T
            t = torch.tensor(np.ascontiguousarray(a), device=device)
            if moment_dtype is not None and slot.startswith("moment"):
                t = t.to(moment_dtype)
            out[name][slot] = t
    return out


def adam_state_to_numpy(state: Dict[str, Dict[str, torch.Tensor]]
                        ) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of adam_state_from_numpy: the port's Adam state ->
    {name: {slot: f32 array}} in the JAX package's layout."""
    out = {}
    for name, slots in state.items():
        lin = name.endswith(LINEAR_SUFFIXES)
        out[name] = {}
        for slot, t in slots.items():
            a = _numpy_of(t)
            if lin and slot.startswith("moment"):
                a = a.T
            out[name][slot] = np.ascontiguousarray(a)
    return out
