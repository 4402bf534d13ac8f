"""Activation checkpointing (counterpart of
``paddle_tpu/distributed/fleet/recompute/recompute.py:77``).

``recompute(fn, *args)`` runs ``fn`` keeping none of its activations;
the backward reruns it to get them back. It is
``torch.utils.checkpoint.checkpoint`` in its non-reentrant form, which
saves the RNG state (dropout replays the same mask) and lets gradients
reach every parameter ``fn`` reads, like the JAX package's
``jax.checkpoint``. Only full recompute is carried: selective policies
(``checkpoint_name`` / ``save_only_names``) raise NotImplementedError.
"""
from __future__ import annotations

import torch.utils.checkpoint


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` with activation recomputation.

    ``preserve_rng_state`` (default True) is honoured; ``use_reentrant``
    is accepted for API parity and ignored (always non-reentrant);
    ``policy`` (selective recompute) raises NotImplementedError."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    if kwargs.pop("policy", None) is not None:
        raise NotImplementedError(
            "selective recompute policies (save_only_names) come with a "
            "later slice of the port; only full recompute is carried")
    return torch.utils.checkpoint.checkpoint(
        function, *args, use_reentrant=False, preserve_rng_state=preserve,
        **kwargs)
