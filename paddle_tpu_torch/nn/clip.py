"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

A clip object is handed to an optimizer (``grad_clip=``), which applies
it to the gradients before the update; ``TrainStep`` does the same
through ``clip_grads``, whose math is ``_clip_pytree``
(``paddle_tpu/jit/api.py:586-608``). Every clip returns new gradient
tensors and leaves its inputs alone.
"""
from __future__ import annotations

from typing import List, Optional

import torch


class ClipGradBase:
    def _clip(self, grads: List[Optional[torch.Tensor]]
              ) -> List[Optional[torch.Tensor]]:
        raise NotImplementedError

    def clip_grads(self, grads):
        """New clipped gradients for ``grads`` (torch tensors, or the
        eager surface's Tensors, which come back wrapped)."""
        from ..core.tensor import Tensor
        if not any(isinstance(g, Tensor) for g in grads):
            return self._clip(list(grads))
        out = self._clip([g._data if isinstance(g, Tensor) else g
                          for g in grads])
        return [None if g is None else Tensor._from_data(g) for g in out]

    def __call__(self, params_grads):
        """The JAX package's form: [(param, grad)] -> [(param, clipped)]."""
        params = [p for p, _ in params_grads]
        return list(zip(params, self.clip_grads([g for _, g in
                                                 params_grads])))


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element into [min, max] (min defaults to
    -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _clip(self, grads):
        return [None if g is None else torch.clamp(g, self.min, self.max)
                for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient whose own L2 norm exceeds ``clip_norm`` down to
    it."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, grads):
        out = []
        for g in grads:
            if g is None:
                out.append(None)
                continue
            n = torch.sqrt(torch.sum(torch.square(g)))
            s = torch.where(n > self.clip_norm,
                            self.clip_norm / torch.clamp(n, min=1e-12), 1.0)
            out.append(g * s)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale all gradients by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken over every gradient in f32 (counterpart of
    ``ClipGradByGlobalNorm``, ``paddle_tpu/nn/clip.py:57``)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    def global_norm(self, grads):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads if g is not None))

    def _clip(self, grads):
        if all(g is None for g in grads):
            return list(grads)
        gn = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return [None if g is None else (g.float() * scale).to(g.dtype)
                for g in grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` (surface Parameters) in place
    by ``min(max_norm / max(total norm, 1e-6), 1)``; returns the total
    norm as a 0-d Tensor (counterpart of ``clip_grad_norm_``,
    ``paddle_tpu/nn/clip.py:91``)."""
    from ..core.tensor import Tensor
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    grads = [p.grad._data for p in parameters if p.grad is not None]
    if not grads:
        return Tensor._from_data(torch.zeros(()))
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([(g.abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(scale.to(g.dtype))
    return Tensor._from_data(total)
