"""Layer functionalization (counterpart of ``paddle_tpu/jit/functional.py``).

A surface ``Layer`` is not a ``torch.nn.Module``: its parameters and
buffers are surface ``Tensor``s, each wrapping a torch tensor
(``_data``). To run it on other tensors, as ``TrainStep`` (bf16 copies of
the weights), ``jit.save`` (the exported program's inputs) and hapi do,
``bind_state`` swaps the ``_data`` of its Tensors for the given torch
tensors and restores them on exit, the JAX package's re-binding.

Unlike the JAX ``functional_call``, which runs with the dygraph tape off
because ``jax.grad`` differentiates the whole step, this one leaves
torch autograd as the caller set it: the bound tensors carry their own
graph, so ``torch.autograd.grad`` of an output reaches them.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from ..core.tensor import Tensor


def get_params(layer) -> Dict[str, torch.Tensor]:
    """{structured name: torch tensor} of the trainable parameters."""
    return {name: p._data for name, p in layer.named_parameters()
            if not p.stop_gradient}


def get_frozen(layer) -> Dict[str, torch.Tensor]:
    return {name: p._data for name, p in layer.named_parameters()
            if p.stop_gradient}


def get_buffers(layer) -> Dict[str, torch.Tensor]:
    return {name: b._data for name, b in layer.named_buffers()}


def _tensor_registry(layer):
    reg = dict(layer.named_parameters())
    reg.update(layer.named_buffers())
    return reg


@contextlib.contextmanager
def bind_state(layer, *state_dicts):
    """Swap the torch tensors inside the layer's Tensors for the given
    ones (by structured name) and restore them on exit. Buffers a forward
    rebinds are visible on the yielded registry until then."""
    reg = _tensor_registry(layer)
    saved = {name: t._data for name, t in reg.items()}
    try:
        for sd in state_dicts:
            for name, arr in sd.items():
                if name in reg:
                    reg[name]._data = arr
        yield reg
    finally:
        for name, t in reg.items():
            t._data = saved[name]


def _unwrap_tree(out):
    if isinstance(out, Tensor):
        return out._data
    if isinstance(out, (list, tuple)):
        return type(out)(_unwrap_tree(o) for o in out)
    if isinstance(out, dict):
        return {k: _unwrap_tree(v) for k, v in out.items()}
    return out


#: how many ``functional_call``s are running (nested calls count each)
_active = 0


def in_functional_call() -> bool:
    """True inside ``functional_call``: the counterpart of a JAX trace
    (``jax.grad`` of the JAX ``TrainStep``), where every array op is
    differentiated, the batch statistics of a training batch norm too;
    the eager tape of either package treats them as constants."""
    return _active > 0


def functional_call(layer, params, buffers, args, kwargs=None,
                    frozen=None, rng_key=None, training=None):
    """Run ``layer`` on ``args`` (torch tensors, passed in as surface
    Tensors) with its parameters and buffers taken from the {name: torch
    tensor} dicts; ``training`` sets the mode for the call. Returns
    (outputs as torch tensors, the buffers after the call). ``rng_key``
    has no counterpart: dropout draws from the port's generators."""
    if rng_key is not None:
        raise NotImplementedError(
            "functional_call: the port has no PRNG keys; dropout draws "
            "from the generator of its device (paddle.seed)")
    global _active
    kwargs = kwargs or {}
    was_training = layer.training
    if training is not None:
        layer.train() if training else layer.eval()
    _active += 1
    try:
        with bind_state(layer, params, buffers, frozen or {}) as reg:
            targs = [Tensor._from_data(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
            out = _unwrap_tree(layer(*targs, **kwargs))
            new_buffers = {n: reg[n]._data for n in buffers}
    finally:
        _active -= 1
        if training is not None:
            layer.train() if was_training else layer.eval()
    return out, new_buffers


def write_back(layer, params, buffers=None, registry=None):
    """Copy the given tensors into the layer's Tensors in place (their
    leaves stay the ones an optimizer holds). Pass a prebuilt
    ``registry`` (``_tensor_registry``) on hot paths."""
    reg = registry if registry is not None else _tensor_registry(layer)
    with torch.no_grad():
        for sd in (params, buffers or {}):
            for name, arr in sd.items():
                if name in reg and reg[name]._data is not arr:
                    reg[name]._data.copy_(arr)
