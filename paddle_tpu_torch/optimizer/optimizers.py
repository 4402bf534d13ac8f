"""Adam and AdamW (counterparts of ``paddle_tpu/optimizer/optimizers.py``
``Adam`` :108 and ``AdamW`` :168), with the JAX package's exact math:

- ``beta1_pow`` / ``beta2_pow`` are per-parameter f32 scalars that start
  at beta1 / beta2 (:133-134) and are multiplied by the betas after each
  update;
- moments are stored in ``moment_dtype`` (default: the parameter's) and
  updated in f32, rounded to nearest even on store;
- ``lr_t = lr * sqrt(1 - beta2_pow) / (1 - beta1_pow)`` and
  ``denom = sqrt(m2) + eps * sqrt(1 - beta2_pow)`` (:139-160);
- Adam folds ``weight_decay`` into the gradient as L2 (``_apply_l2``);
  AdamW decays the parameter, ``p *= 1 - lr * coeff``, BEFORE the Adam
  step (:181-184), default coefficient 0.01.

``torch.optim.AdamW`` is a different function (other bias correction and
epsilon placement), so the update is written out here, in place.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, _decay_value


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, moment_dtype=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        if multi_precision:
            raise NotImplementedError(
                "multi_precision (f32 masters of half-precision params) "
                "comes with a later slice of the port; TrainStep keeps f32 "
                "masters and casts for the forward (amp_dtype)")
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad
        self._moment_dtype = None if moment_dtype is None else (
            moment_dtype if isinstance(moment_dtype, torch.dtype)
            else getattr(torch, str(moment_dtype)))

    def _init_state(self, param):
        mdt = self._moment_dtype or param.dtype
        dev = param.device
        s = {"moment1": torch.zeros(param.shape, dtype=mdt, device=dev),
             "moment2": torch.zeros(param.shape, dtype=mdt, device=dev),
             "beta1_pow": torch.full((), self._beta1, dtype=param.dtype,
                                     device=dev),
             "beta2_pow": torch.full((), self._beta2, dtype=param.dtype,
                                     device=dev)}
        if self._amsgrad:
            s["moment2_max"] = torch.zeros(param.shape, dtype=mdt,
                                           device=dev)
        return s

    def _adam_core(self, p, g, state, lr):
        """In place: p -= lr_t * m1 / denom; moments and beta powers
        advanced (``_adam_core``, :139)."""
        g32 = g.float()
        m1 = self._beta1 * state["moment1"].float() + (1 - self._beta1) * g32
        m2 = self._beta2 * state["moment2"].float() \
            + (1 - self._beta2) * g32 * g32
        b1p, b2p = state["beta1_pow"], state["beta2_pow"]
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        if self._amsgrad:
            m2m = torch.maximum(state["moment2_max"].float(), m2)
            denom = torch.sqrt(m2m) + self._epsilon * torch.sqrt(1 - b2p)
            state["moment2_max"].copy_(m2m)
        else:
            denom = torch.sqrt(m2) + self._epsilon * torch.sqrt(1 - b2p)
        p.sub_((lr_t * m1 / denom).to(p.dtype))
        state["moment1"].copy_(m1)
        state["moment2"].copy_(m2)
        b1p.mul_(self._beta1)
        b2p.mul_(self._beta2)

    def _update(self, p, g, state, lr, wd=None):
        c = _decay_value(wd if wd is not None else self._weight_decay)
        if c:
            g = g + c * p            # L2 folded into the gradient
        self._adam_core(p, g, state, lr)


class AdamW(Adam):
    """Decoupled weight decay (``AdamW``, :168). ``TrainStep`` decays
    every parameter, norms included, as the JAX ``TrainStep`` does (it
    passes no decay mask); ``apply_decay_param_fun`` is read by neither
    TrainStep, and the eager step of the port does not carry it yet."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 moment_dtype=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, moment_dtype=moment_dtype,
                         name=name)
        if lr_ratio is not None:
            raise NotImplementedError(
                "lr_ratio comes with a later slice of the port")
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update(self, p, g, state, lr, wd=None):
        coeff = _decay_value(wd if wd is not None else self._weight_decay)
        if coeff:
            p.mul_(1.0 - lr * coeff)
        self._adam_core(p, g, state, lr)

    def step(self):
        if self._apply_decay_param_fun is not None:
            raise NotImplementedError(
                "apply_decay_param_fun in the eager step comes with a later "
                "slice of the port (TrainStep ignores it, as the JAX "
                "TrainStep does)")
        return super().step()
