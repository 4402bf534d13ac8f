"""Activation checkpointing (counterpart of
``paddle_tpu/distributed/fleet/recompute/recompute.py``).

``recompute(fn, *args)`` runs ``fn`` keeping none of its activations;
the backward reruns it to get them back. It is
``torch.utils.checkpoint.checkpoint`` in its non-reentrant form, which
saves the RNG state (dropout replays the same mask) and lets gradients
reach every parameter ``fn`` reads, like the JAX package's
``jax.checkpoint``.

Selective recompute (:58-71) is PyTorch's selective activation
checkpointing. ``checkpoint_name(x, name)`` tags an activation: an
identity op (``paddle_tpu_torch::checkpoint_name``, a
``torch.library.custom_op`` with a fake implementation and an identity
gradient). ``save_only_names(*names)`` is a policy that marks the tagged
ops whose name is in the set MUST_SAVE and every other op
PREFER_RECOMPUTE; ``recompute(fn, *args, policy=...)`` hands it to the
checkpoint through ``create_selective_checkpoint_contexts``. The
backward then reruns ``fn`` with the saved tags' outputs taken from the
forward. Two costs follow:

- a custom op may not return its input aliased, so a tag copies its
  tensor once (one read and one write of it);
- the flash kernels launch through ``ctypes``, which PyTorch's dispatch
  never sees, so the rerun launches the flash forward again, as the JAX
  package's recompute does (its lse carries no name).

Each run of a tag's implementation counts on
``recompute.checkpoint_name.<name>``: a saved tag runs once a step (the
forward), a recomputed one twice.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from ... import monitor


@torch.library.custom_op("paddle_tpu_torch::checkpoint_name",
                         mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    monitor.counter(f"recompute.checkpoint_name.{name}").increase()
    return x.clone()


@_checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


def _checkpoint_name_backward(ctx, grad):
    return grad, None


_checkpoint_name.register_autograd(_checkpoint_name_backward)


def checkpoint_name(x, name):
    """Tag ``x`` as the activation ``name`` for a selective policy (a
    copy of ``x``; its gradient passes through unchanged)."""
    return _checkpoint_name(x, name)


def _policy(names, ctx, op, *args, **kwargs):
    if op is torch.ops.paddle_tpu_torch.checkpoint_name.default \
            and args[1] in names:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def save_only_names(*names):
    """Policy: save only the ``checkpoint_name``-tagged activations with
    these names; recompute everything else inside the checkpointed
    region."""
    return functools.partial(_policy, frozenset(names))


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` with activation recomputation.

    ``preserve_rng_state`` (default True) is honoured; ``use_reentrant``
    is accepted for API parity and ignored (always non-reentrant);
    ``policy`` (``save_only_names(...)``) makes the recompute
    selective."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    policy = kwargs.pop("policy", None)
    if policy is not None:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return torch.utils.checkpoint.checkpoint(
        function, *args, use_reentrant=False, preserve_rng_state=preserve,
        **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Checkpoint a sequence of layers in ``ctx["segments"]`` chunks
    (``recompute_sequential``, :143): each chunk runs as one recomputed
    function, its output feeding the next."""
    segments = int((ctx or {}).get("segments", 1))
    if isinstance(functions, torch.nn.Module):
        functions = list(functions.children()) or [functions]
    functions = list(functions)
    per = max(1, len(functions) // max(1, segments))

    def run_chunk(chunk, *xs):
        x = chunk[0](*xs)
        for f in chunk[1:]:
            x = f(x)
        return x

    out = args
    i = 0
    while i < len(functions):
        out = recompute(functools.partial(run_chunk, functions[i:i + per]),
                        *out, **kwargs)
        if not isinstance(out, tuple):
            out = (out,)
        i += per
    return out[0] if len(out) == 1 else out
