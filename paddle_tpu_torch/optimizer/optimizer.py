"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

As in the JAX package, every optimizer states its math once as a
per-parameter rule ``_update(p, g, state, lr, wd)``, and two callers run
it: the eager ``step()``, over each parameter's ``.grad``, and
``apply_gradients_pytree``, over {name: tensor} dicts, which
``jit.TrainStep`` calls. Unlike the JAX rule, which returns new arrays,
the port's rule updates the parameter and its state tensors IN PLACE
(under ``torch.no_grad()``), so a step allocates no second copy of the
model or of its moments.

The learning rate is a float (``get_lr`` / ``set_lr``). Not carried yet,
each raising NotImplementedError: ``LRScheduler`` learning rates and
parameter groups.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..nn.clip import ClipGradBase


def _decay_value(wd) -> float:
    """A weight-decay coefficient from a float or an L2Decay-like object
    (counterpart of ``_decay_value``, :218)."""
    if wd is None:
        return 0.0
    if isinstance(wd, (int, float)):
        return float(wd)
    return float(getattr(wd, "_coeff", getattr(wd, "coeff", 0.0)))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError(
                "parameters is required (pass model.parameters())")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "LRScheduler learning rates come with a later slice of the "
                "port; pass a float")
        self._parameter_list = list(parameters)
        if self._parameter_list and isinstance(self._parameter_list[0],
                                               dict):
            raise NotImplementedError(
                "parameter groups come with a later slice of the port")
        self._learning_rate = float(learning_rate)
        self._weight_decay = weight_decay
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise TypeError(
                "grad_clip must be a paddle_tpu_torch.nn.Clip* object")
        self._grad_clip = grad_clip
        #: eager-step state: {id(param): {slot: tensor}}
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # -- the rule (subclasses) ----------------------------------------------
    def _init_state(self, param) -> Dict[str, torch.Tensor]:
        """Per-parameter state (zeros), shaped after ``param``."""
        return {}

    def _update(self, p, g, state, lr, wd=None):
        """Update ``p`` and ``state`` in place from gradient ``g``."""
        raise NotImplementedError

    def _lr_tensor(self, lr, device):
        return torch.tensor(float(lr), dtype=torch.float32, device=device)

    # -- eager step ----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """Apply one update from each parameter's ``.grad`` (parameters
        without a gradient are skipped)."""
        params = [p for p in self._parameter_list
                  if p.requires_grad and p.grad is not None]
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            grads = self._grad_clip.clip_grads(grads)
        for p, g in zip(params, grads):
            state = self._accumulators.get(id(p))
            if state is None:
                state = self._accumulators[id(p)] = self._init_state(p)
            self._update(p, g.to(p.dtype),
                         state, self._lr_tensor(self.get_lr(), p.device))

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # -- the TrainStep path --------------------------------------------------
    def init_state_pytree(self, params: Dict[str, torch.Tensor]):
        """{name: param} -> {name: {slot: tensor}}"""
        return {name: self._init_state(p) for name, p in params.items()}

    @torch.no_grad()
    def apply_gradients_pytree(self, params: Dict[str, torch.Tensor],
                               grads: Dict[str, Optional[torch.Tensor]],
                               state, lr, wd_mask=None):
        """Whole-model update used by ``TrainStep``: every parameter and
        its state are updated in place. ``wd_mask`` maps name -> bool
        (False: no weight decay for that parameter); absent, as
        ``TrainStep`` calls it, every parameter is decayed."""
        lr_t = None
        for name, p in params.items():
            g = grads[name]
            if g is None:
                continue
            if lr_t is None or lr_t.device != p.device:
                lr_t = self._lr_tensor(lr, p.device)
            wd = self._weight_decay
            if wd_mask is not None and not wd_mask.get(name, True):
                wd = None
            self._update(p, g.to(p.dtype), state[name], lr_t, wd)
