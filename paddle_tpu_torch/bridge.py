"""Weight bridge: JAX-package parameters and optimizer state -> the
port's, and back.

The JAX package names parameters as ``paddle_tpu.jit.functional.
get_params`` gives them (``llama.layers.0.self_attn.q_proj.weight``,
``layers.1.mlp.experts.w1``, ...), and the port's modules carry the same
names. The one layout
difference: a paddle Linear weight is [in, out], a ``torch.nn.Linear``
weight is [out, in], so every 2-D weight of a Linear is transposed.
Embedding ([vocab, hidden]) and norm parameters cross as they are. A
linear converted by ``quantize_for_inference`` keeps the JAX layout in
both packages (``weight`` int8 [in, out] beside its ``weight_scale``, and
``bias``): such a weight, known by its int8 dtype or its sibling
``weight_scale``, crosses untransposed with its buffers. Any
optimizer's state ({name: {slot: array}}, the JAX ``TrainStep``'s
``_opt_state``: Adam's moments and beta powers, Momentum's velocity,
NAdam's step, ...) crosses the same way: a Linear's slots shaped like
its weight are transposed like it, the scalars cross as they are.
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


def _float_linear(name, state, dtype) -> bool:
    """Whether ``name`` is the weight of a float Linear (transposed across),
    not of a quantized one (int8, or with a ``weight_scale`` beside it)."""
    return (name.endswith(LINEAR_SUFFIXES)
            and str(dtype) not in ("int8", "torch.int8")
            and name + "_scale" not in state)


#: tensor-parallel shards in the port's layout, by parameter-name
#: suffix: (suffix, dim, blocks). A column-parallel Linear's weight
#: ([out, in] here) and bias split on dim 0, a row-parallel weight on
#: dim 1, a vocabulary-parallel embedding on dim 0; ``blocks`` > 1
#: splits each of that many equal blocks on its own (BERT's fused qkv:
#: rank r takes the q, k and v rows of its heads). Other parameters are
#: whole on every rank.
TP_RULES = {
    "llama": (("embed_tokens.weight", 0, 1), ("q_proj.weight", 0, 1),
              ("k_proj.weight", 0, 1), ("v_proj.weight", 0, 1),
              ("gate_proj.weight", 0, 1), ("up_proj.weight", 0, 1),
              ("o_proj.weight", 1, 1), ("down_proj.weight", 1, 1),
              ("lm_head.weight", 0, 1)),
    "bert": (("word_embeddings.weight", 0, 1), (".qkv.weight", 0, 3),
             (".qkv.bias", 0, 3), (".out.weight", 1, 1),
             (".fc1.weight", 0, 1), (".fc1.bias", 0, 1),
             (".fc2.weight", 1, 1)),
}


def _tp_rule(family, name):
    return next(((d, b) for suffix, d, b in TP_RULES[family]
                 if name.endswith(suffix)), None)


def tp_shard(a, family: str, name: str, mp_rank: int, mp_degree: int):
    """Rank ``mp_rank``'s part of the global port-layout array ``a`` of
    parameter ``name`` (``a`` itself for a whole parameter)."""
    rule = _tp_rule(family, name)
    if rule is None or mp_degree == 1:
        return a
    dim, blocks = rule
    parts = []
    for blk in np.split(a, blocks, axis=dim):
        size = blk.shape[dim] // mp_degree
        parts.append(np.take(blk, np.arange(mp_rank * size,
                                            (mp_rank + 1) * size), axis=dim))
    return np.concatenate(parts, axis=dim)


def tp_merge(shards, family: str, name: str):
    """The global port-layout array of parameter ``name`` from its ranks'
    parts (``shards[r]`` of mp rank r), the inverse of ``tp_shard``; a
    whole parameter comes from rank 0. Torch tensors merge as torch
    tensors, on their device."""
    rule = _tp_rule(family, name)
    if torch.is_tensor(shards[0]):
        split, cat = torch.chunk, torch.cat
    else:
        shards = [np.asarray(s) for s in shards]
        split, cat = np.split, np.concatenate
    if rule is None or len(shards) == 1:
        return shards[0]
    dim, blocks = rule
    per = [split(s, blocks, dim) for s in shards]
    return cat([cat([p[b] for p in per], dim) for b in range(blocks)], dim)


def _state_from_numpy(params, family, mp_rank, mp_degree):
    out = {}
    for name, arr in params.items():
        a = np.asarray(arr)
        if _float_linear(name, params, a.dtype):
            if a.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D Linear weight, "
                                 f"got shape {a.shape}")
            a = a.T
        a = tp_shard(a, family, name, mp_rank, mp_degree)
        out[name] = torch.tensor(np.ascontiguousarray(a))
    return out


def llama_state_from_numpy(params: Dict[str, np.ndarray], mp_rank: int = 0,
                           mp_degree: int = 1) -> Dict[str, torch.Tensor]:
    """{name: array} in the JAX package's layout -> a state_dict for
    ``paddle_tpu_torch.text.models.LlamaForCausalLM.load_state_dict`` (of
    a converted model too: its buffers are among the arrays). With
    ``mp_degree`` > 1, the state of mp rank ``mp_rank``'s shard of a
    tensor-parallel model (``TP_RULES["llama"]``)."""
    return _state_from_numpy(params, "llama", mp_rank, mp_degree)


def llama_state_to_numpy(state: Dict[str, torch.Tensor]
                         ) -> Dict[str, np.ndarray]:
    """The inverse of llama_state_from_numpy: a port state_dict -> {name:
    array} in the JAX package's layout."""
    out = {}
    for name, t in state.items():
        a = t.detach().cpu().numpy()
        out[name] = np.ascontiguousarray(
            a.T if _float_linear(name, state, t.dtype) else a)
    return out


#: ERNIE-MoE crosses by the same rule: its ``*_proj.weight`` and
#: ``lm_head.weight`` are transposed, and the MoE blocks' raw parameters
#: (``gate_weight`` [h, E], ``experts.w1`` [E, h, dff], ``b1`` [E, 1, dff],
#: ``w2``, ``b2``) are kept in the JAX layout by the port and cross as they
#: are — so the Adam state bridge below holds for MoE unchanged.
ernie_moe_state_to_numpy = llama_state_to_numpy

#: expert-parallel shards: an MoE block's stacked expert parameters, split
#: on dim 0 (the experts) over the ep group, rank r holding rows
#: [r E / n, (r + 1) E / n)
EP_SUFFIXES = ("experts.w1", "experts.b1", "experts.w2", "experts.b2")


def ep_shard(a, name: str, ep_rank: int, ep_degree: int):
    """Rank ``ep_rank``'s rows of the global expert parameter ``a`` (``a``
    itself for a parameter not split over ep)."""
    if ep_degree == 1 or not name.endswith(EP_SUFFIXES):
        return a
    e = a.shape[0] // ep_degree
    return a[ep_rank * e:(ep_rank + 1) * e]


def ep_merge(shards, name: str):
    """The global expert parameter from its ep ranks' rows (``shards[r]``
    of rank r), the inverse of ``ep_shard``; another parameter from rank
    0. Torch tensors merge as torch tensors."""
    if len(shards) == 1 or not name.endswith(EP_SUFFIXES):
        return shards[0]
    if torch.is_tensor(shards[0]):
        return torch.cat(list(shards))
    return np.concatenate([np.asarray(x) for x in shards])


def ernie_moe_state_from_numpy(params: Dict[str, np.ndarray],
                               mp_rank: int = 0, mp_degree: int = 1,
                               ep_rank: int = 0, ep_degree: int = 1
                               ) -> Dict[str, torch.Tensor]:
    """``llama_state_from_numpy`` for ERNIE-MoE; with ``ep_degree`` > 1,
    ep rank ``ep_rank``'s rows of every MoE block's experts
    (``EP_SUFFIXES``)."""
    out = llama_state_from_numpy(params, mp_rank, mp_degree)
    return {n: ep_shard(t, n, ep_rank, ep_degree) for n, t in out.items()}


#: BERT crosses by the same rule: its Linear weights are transposed, the
#: embeddings and LayerNorm parameters cross as they are, and the MLM
#: decoder is the word embedding itself (one parameter, crossed once). The
#: Adam state bridge below holds for BERT unchanged.
bert_state_to_numpy = llama_state_to_numpy


def bert_state_from_numpy(params: Dict[str, np.ndarray], mp_rank: int = 0,
                          mp_degree: int = 1) -> Dict[str, torch.Tensor]:
    """The BERT counterpart of ``llama_state_from_numpy``: with
    ``mp_degree`` > 1, mp rank ``mp_rank``'s shard, whose fused qkv holds
    the q, k and v of its heads (the JAX package's global [h, 3h] weight
    is column-split by head within each of q, k and v, not by column)."""
    return _state_from_numpy(params, "bert", mp_rank, mp_degree)


def _numpy_of(t):
    if t.dtype == torch.bfloat16:        # numpy has no bfloat16
        t = t.float()
    return t.detach().cpu().numpy()


def optimizer_state_from_numpy(state: Dict[str, Dict[str, np.ndarray]],
                               device=None, moment_dtype=None
                               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Any optimizer's state in the JAX package's layout (a
    ``TrainStep._opt_state`` as numpy: {param name: {slot: array}}) ->
    the port's ``TrainStep.opt_state``. Every slot shaped like its
    parameter is transposed with a Linear weight; ASGD's ``y`` window
    ([n, *shape]) has its last two axes transposed; scalars (beta powers,
    step counts) cross as they are, in their dtype. ``moment_dtype``
    (default: as given) applies to the ``moment*`` slots."""
    out = {}
    for name, slots in state.items():
        out[name] = {}
        for slot, arr in slots.items():
            a = np.asarray(arr)
            if a.dtype.kind == "f":
                a = a.astype(np.float32)
            a = _linear_layout(name, slot, a)
            t = torch.tensor(np.array(a, order="C"), device=device)
            if moment_dtype is not None and slot.startswith("moment"):
                t = t.to(moment_dtype)
            out[name][slot] = t
    return out


def optimizer_state_to_numpy(state: Dict[str, Dict[str, torch.Tensor]]
                             ) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of optimizer_state_from_numpy: the port's optimizer
    state -> {name: {slot: array}} in the JAX package's layout (floating
    slots as f32)."""
    out = {}
    for name, slots in state.items():
        out[name] = {slot: np.array(
            _linear_layout(name, slot, _numpy_of(t)), order="C")
            for slot, t in slots.items()}
    return out


def _linear_layout(name, slot, a):
    """A Linear weight's state slot in the other layout: its last two axes
    swapped (the moments, velocities, ... and ASGD's [n, in, out] window;
    the 0-d scalars stay)."""
    if name.endswith(LINEAR_SUFFIXES) and a.ndim >= 2:
        return np.swapaxes(a, -1, -2)
    return a


#: the Adam / AdamW state bridges' first names
adam_state_from_numpy = optimizer_state_from_numpy
adam_state_to_numpy = optimizer_state_to_numpy


def layer_state_from_jax(jax_layer) -> Dict[str, np.ndarray]:
    """{structured name: array} of a JAX-package ``nn.Layer``'s state dict
    (parameters and persistable buffers), for the eager surface's
    ``Layer.set_state_dict``. Reads the layer through its own methods;
    imports nothing of the JAX package.

    The eager surface keeps the JAX layers' names and layouts, so every
    entry crosses as it is:

    - Linear ``weight`` [in, out] (paddle's layout) and ``bias``;
    - Conv*D ``weight`` [out, in/groups, *k], Conv*DTranspose ``weight``
      [in, out/groups, *k] (torch's layouts too), ``bias`` [out];
      ``vision.ops.DeformConv2D`` ``weight`` [out, in/groups, kh, kw] and
      ``bias`` [out], as Conv2D's (so every ``vision.models`` factory
      crosses with no missing and no unexpected key);
    - BatchNorm*D ``weight``, ``bias`` and the buffers ``_mean`` /
      ``_variance`` [C];
    - SimpleRNN / LSTM / GRU ``weight_ih_l{k}`` [G*H, in], ``weight_hh_l{k}``
      [G*H, H], ``bias_ih_l{k}`` / ``bias_hh_l{k}`` [G*H], with
      ``_reverse`` for the backward direction (G 1, 4 or 3; the gate
      orders are torch's), and the cells' ``weight_ih`` / ``weight_hh`` /
      ``bias_ih`` / ``bias_hh``."""
    return {name: np.asarray(t.numpy())
            for name, t in jax_layer.state_dict().items()}


def layer_state_to_numpy(layer) -> Dict[str, np.ndarray]:
    """The inverse of layer_state_from_jax: an eager-surface ``Layer``'s
    state dict as {structured name: array}, for a JAX-package layer's
    ``set_state_dict`` (bfloat16 entries as float32)."""
    return {name: _numpy_of(t._data)
            for name, t in layer.state_dict().items()}


def _pipe_to_llama_names(n_layers: int, tied: bool):
    """{pipe name: LlamaForCausalLM name} of ``build_llama_pipe``'s items:
    0 the embedding, 1..L the decoder layers, L+1 the final norm, L+2 the
    head (absent when tied: the embedding is item 0's)."""
    def rename(name):
        idx, _, rest = name.partition(".")
        i = int(idx)
        if i == 0:
            return f"llama.embed_tokens.{rest}"
        if i <= n_layers:
            return f"llama.layers.{i - 1}.{rest}"
        if i == n_layers + 1:
            return f"llama.norm.{rest}"
        if i == n_layers + 2 and not tied:
            return f"lm_head.{rest}"
        raise KeyError(f"{name} is no parameter of a {n_layers}-layer "
                       f"LLaMA pipe")
    return rename


def pipe_state_from_numpy(params: Dict[str, np.ndarray], config,
                          mp_rank: int = 0, mp_degree: int = 1,
                          names=None) -> Dict[str, torch.Tensor]:
    """The JAX ``build_llama_pipe`` ``PipelineLayer``'s parameters (named
    by item index: ``0.weight``, ``1.self_attn.q_proj.weight``, ...,
    ``{L+2}.weight`` the untied head) -> a state_dict of the port's
    ``build_llama_pipe`` (the same names; Linear weights transposed,
    mp rank ``mp_rank``'s shard under TP). ``names``: keep only these
    (one stage's slice, ``PipelineParallel.state_dict()``'s keys)."""
    rename = _pipe_to_llama_names(config.num_hidden_layers,
                                  config.tie_word_embeddings)
    as_llama = {rename(n): a for n, a in params.items()}
    back = {rename(n): n for n in params}
    state = llama_state_from_numpy(as_llama, mp_rank, mp_degree)
    keep = None if names is None else set(names)
    return {back[n]: t for n, t in state.items()
            if keep is None or back[n] in keep}


def pipe_state_to_numpy(state: Dict[str, torch.Tensor], config
                        ) -> Dict[str, np.ndarray]:
    """The inverse of ``pipe_state_from_numpy`` (one stage's slice gives
    that slice's arrays)."""
    rename = _pipe_to_llama_names(config.num_hidden_layers,
                                  config.tie_word_embeddings)
    back = {rename(n): n for n in state}
    out = llama_state_to_numpy({rename(n): t for n, t in state.items()})
    return {back[n]: a for n, a in out.items()}
