"""Viterbi decoding over CRF transition scores (counterpart of
``paddle_tpu/text/viterbi.py``; the reference's text.ViterbiDecoder /
viterbi_decode).

The JAX package's convention, carried as it is: with
``include_bos_eos_tag`` the transition *row* ``N - 1`` (start) seeds the
scores and the *row* ``N - 2`` (stop) is added at each sequence's last
valid step. ``ops.search.viterbi_decode`` (the other JAX Viterbi) adds
the stop *column* once at the end instead; the two disagree for an
asymmetric matrix.

The recursion is a Python loop over T of a few launches a step, with
nothing read back to the host; the back-pointers are ``argmax`` (the
first maximum, as ``jnp.argmax``) and the scores' maxima ``amax`` (a
tie splits the gradient evenly, as ``jnp.max``'s does). The scores are
differentiable in the emissions and the transitions.
"""
from __future__ import annotations

import torch

from ..core.dispatch import run_op


def _decode(emis, trans, lens, include_bos_eos_tag):
    B, T, N = emis.shape
    lens = lens.to(emis.device)
    zero = emis.new_zeros(())
    if include_bos_eos_tag:
        stop_row = trans[N - 2][None, :]
        alpha = trans[N - 1][None, :] + emis[:, 0]
        alpha = alpha + torch.where((lens == 1)[:, None], stop_row, zero)
    else:
        stop_row = None
        alpha = emis[:, 0]
    history = []
    for t in range(1, T):
        scores = alpha[:, :, None] + trans[None, :, :]
        history.append(torch.argmax(scores, dim=1))          # [B, N]
        alpha_t = scores.amax(dim=1) + emis[:, t]
        if stop_row is not None:
            alpha_t = alpha_t + torch.where((lens - 1 == t)[:, None],
                                            stop_row, zero)
        # sequences already past their length keep their alpha
        alpha = torch.where((lens > t)[:, None], alpha_t, alpha)
    best = alpha.amax(dim=-1)
    tag = torch.argmax(alpha, dim=-1)                         # [B]
    path = [tag]
    for t in range(T - 2, -1, -1):
        prev = torch.take_along_dim(history[t], tag[:, None], dim=1)[:, 0]
        tag = torch.where(lens > t + 1, prev, tag)
        path.append(tag)
    return best, torch.stack(path[::-1], dim=1).to(torch.int64)


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """Best tag path per sequence: potentials [B, T, N], transitions
    [N, N], lengths [B]. Returns (scores [B], paths [B, T] int64)."""
    return run_op("viterbi_decode",
                  lambda e, tr, ln: _decode(e, tr, ln, include_bos_eos_tag),
                  [potentials, transition_params, lengths])


class ViterbiDecoder:
    """Layer-style wrapper (the reference's text.ViterbiDecoder)."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
