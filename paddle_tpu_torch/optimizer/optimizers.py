"""Concrete optimizers (counterparts of ``paddle_tpu/optimizer/
optimizers.py``): SGD, Momentum, Adagrad, RMSProp, Adam, AdamW, Lamb,
Adamax, Adadelta, NAdam, RAdam, ASGD and Rprop.

Each states the JAX package's per-parameter rule as an in-place
``_update(p, g, state, lr, wd)`` (``lr`` a 0-d f32 tensor on ``p``'s
device), with the JAX rule's operations in its order, so that each
intermediate is rounded where the JAX one is. Adam's family:

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
epsilon placement). Adam and AdamW run their update through
``kernels.fused_adam.adam_update``: one CUDA launch for every float32
parameter on the card, the plain rule (``adam_update_plain``) elsewhere.
"""
from __future__ import annotations

import torch

from ..kernels.fused_adam import adam_update, adam_update_plain
from .optimizer import Optimizer, _decay_value


def _apply_l2(g, p, wd):
    """L2 regularization folds decay into the gradient (paddle semantics
    for SGD/Momentum/Adam with weight_decay=L2Decay)."""
    c = _decay_value(wd)
    if c:
        g = g + c * p
    return g


def _pow(param, value):
    return torch.full((), value, dtype=param.dtype, device=param.device)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update(self, p, g, state, lr, wd=None):
        g = _apply_l2(g, p, wd if wd is not None else self._weight_decay)
        p.sub_(lr * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, param):
        return {"velocity": torch.zeros_like(param)}

    def _update(self, p, g, state, lr, wd=None):
        g = _apply_l2(g, p, wd if wd is not None else self._weight_decay)
        v = state["velocity"]
        v.mul_(self._momentum).add_(g)
        if self._nesterov:
            p.sub_(lr * (g + self._momentum * v))
        else:
            p.sub_(lr * v)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, param):
        return {"moment": torch.full_like(param, self._init_acc)}

    def _update(self, p, g, state, lr, wd=None):
        g = _apply_l2(g, p, wd if wd is not None else self._weight_decay)
        m = state["moment"]
        m.add_(g * g)
        p.sub_(lr * g / (torch.sqrt(m) + self._epsilon))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_state(self, param):
        s = {"mean_square": torch.zeros_like(param),
             "momentum": torch.zeros_like(param)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(param)
        return s

    def _update(self, p, g, state, lr, wd=None):
        g = _apply_l2(g, p, wd if wd is not None else self._weight_decay)
        ms = state["mean_square"]
        ms.mul_(self._rho).add_((1 - self._rho) * g * g)
        if self._centered:
            mg = state["mean_grad"]
            mg.mul_(self._rho).add_((1 - self._rho) * g)
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = state["momentum"]
        mom.mul_(self._momentum).add_(lr * g / denom)
        p.sub_(mom)


class Adam(Optimizer):
    _decay = "l2"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, moment_dtype=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad
        self._multi_precision = bool(multi_precision)
        # moment_dtype="bfloat16": the f32 parameters stay the masters, the
        # moments are stored narrow and the update math runs in f32
        self._moment_dtype = None if moment_dtype is None else (
            moment_dtype if isinstance(moment_dtype, torch.dtype)
            else getattr(torch, str(moment_dtype)))

    def _init_state(self, param):
        mdt = self._moment_dtype or param.dtype
        dev = param.device
        s = {"moment1": torch.zeros(param.shape, dtype=mdt, device=dev),
             "moment2": torch.zeros(param.shape, dtype=mdt, device=dev),
             "beta1_pow": _pow(param, self._beta1),
             "beta2_pow": _pow(param, self._beta2)}
        if self._amsgrad:
            s["moment2_max"] = torch.zeros(param.shape, dtype=mdt,
                                           device=dev)
        return s

    def _coeff(self, wd):
        return _decay_value(wd if wd is not None else self._weight_decay)

    def _update(self, p, g, state, lr, wd=None):
        adam_update_plain(p, g, state, lr, self._beta1, self._beta2,
                          self._epsilon, self._amsgrad, self._decay,
                          self._coeff(wd))

    def _apply_updates(self, items, lr, wd):
        """One fused launch for the items on the "fused" route, the plain
        rule for the others (``kernels.fused_adam.adam_update``)."""
        adam_update(items, lr, self._beta1, self._beta2, self._epsilon,
                    self._amsgrad, self._decay, self._coeff(wd))


class AdamW(Adam):
    """Decoupled weight decay (``AdamW``, :168). ``TrainStep`` decays
    every parameter, norms included, as the JAX ``TrainStep`` does (it
    passes no decay mask, and ``apply_decay_param_fun`` is read by the
    eager step only). ``lr_ratio`` is kept and, as in the JAX package,
    read by no rule."""
    _decay = "decoupled"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 moment_dtype=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, moment_dtype=moment_dtype,
                         name=name)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    @torch.no_grad()
    def step(self):
        """With ``apply_decay_param_fun``, the JAX AdamW's own step
        (:196-215): every parameter at the base lr (no groups, no
        per-parameter rate, no master weights), decayed when
        ``fn(name)`` is true (the name the parameter was given as a
        (name, tensor) pair, else None), else the Adam step alone."""
        if self._apply_decay_param_fun is None:
            return super().step()
        fn = self._apply_decay_param_fun
        lr = self.get_lr()
        params, grads = self._params_with_grads(self._parameter_list)
        decayed, kept = [], []
        for p, g in zip(params, grads):
            item = (p, g.to(p.dtype), self._state_for(p), p.dtype)
            (decayed if fn(self._name_of(p)) else kept).append(item)
        if decayed:
            self._apply_updates(decayed, lr, self._weight_decay)
        if kept:
            adam_update(kept, lr, self._beta1, self._beta2, self._epsilon,
                        self._amsgrad, "none", 0.0)
        self._global_step += 1


class Lamb(Optimizer):
    """``Lamb`` (:218). As in the JAX package, the rule decays every
    parameter by ``lamb_weight_decay``: ``exclude_from_weight_decay_fn``
    is kept and read by no rule."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon = epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, param):
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param),
                "beta1_pow": _pow(param, self._beta1),
                "beta2_pow": _pow(param, self._beta2)}

    def _update(self, p, g, state, lr, wd=None):
        m1, m2 = state["moment1"], state["moment2"]
        m1.mul_(self._beta1).add_((1 - self._beta1) * g)
        m2.mul_(self._beta2).add_((1 - self._beta2) * g * g)
        b1p, b2p = state["beta1_pow"], state["beta2_pow"]
        m1_hat = m1 / (1 - b1p)
        m2_hat = m2 / (1 - b2p)
        r = m1_hat / (torch.sqrt(m2_hat) + self._epsilon) \
            + self._lamb_wd * p
        w_norm = torch.sqrt(torch.sum(p * p))
        r_norm = torch.sqrt(torch.sum(r * r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        p.sub_(lr * trust * r)
        b1p.mul_(self._beta1)
        b2p.mul_(self._beta2)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon = epsilon

    def _init_state(self, param):
        return {"moment": torch.zeros_like(param),
                "inf_norm": torch.zeros_like(param),
                "beta1_pow": _pow(param, self._beta1)}

    def _update(self, p, g, state, lr, wd=None):
        g = _apply_l2(g, p, wd if wd is not None else self._weight_decay)
        m, u = state["moment"], state["inf_norm"]
        m.mul_(self._beta1).add_((1 - self._beta1) * g)
        u.copy_(torch.maximum(self._beta2 * u, torch.abs(g)))
        b1p = state["beta1_pow"]
        p.sub_(lr / (1 - b1p) * m / (u + self._epsilon))
        b1p.mul_(self._beta1)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._epsilon = epsilon
        self._rho = rho

    def _init_state(self, param):
        return {"avg_squared_grad": torch.zeros_like(param),
                "avg_squared_update": torch.zeros_like(param)}

    def _update(self, p, g, state, lr, wd=None):
        g = _apply_l2(g, p, wd if wd is not None else self._weight_decay)
        asg, asu = state["avg_squared_grad"], state["avg_squared_update"]
        asg.mul_(self._rho).add_((1 - self._rho) * g * g)
        update = g * torch.sqrt(asu + self._epsilon) / \
            torch.sqrt(asg + self._epsilon)
        asu.mul_(self._rho).add_((1 - self._rho) * update * update)
        p.sub_(lr * update)


class NAdam(Optimizer):
    """Nesterov Adam (``NAdam``, :303)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._b1, self._b2 = beta1, beta2
        self._epsilon = epsilon
        self._psi = momentum_decay

    def _init_state(self, param):
        dev = param.device
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param),
                "step": torch.zeros((), dtype=torch.float32, device=dev),
                "mu_product": torch.ones((), dtype=torch.float32,
                                         device=dev)}

    def _update(self, p, g, state, lr, wd=None):
        g = _apply_l2(g, p, wd if wd is not None else self._weight_decay)
        t = state["step"] + 1
        mu_t = self._b1 * (1 - 0.5 * 0.96 ** (t * self._psi))
        mu_next = self._b1 * (1 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        mu_prod = state["mu_product"] * mu_t
        m, v = state["moment1"], state["moment2"]
        m.mul_(self._b1).add_((1 - self._b1) * g)
        v.mul_(self._b2).add_((1 - self._b2) * g * g)
        m_hat = (mu_next * m / (1 - mu_prod * mu_next)
                 + (1 - mu_t) * g / (1 - mu_prod))
        v_hat = v / (1 - self._b2 ** t)
        p.sub_(lr * m_hat / (torch.sqrt(v_hat) + self._epsilon))
        state["step"].copy_(t)
        state["mu_product"].copy_(mu_prod)


class RAdam(Optimizer):
    """Rectified Adam (``RAdam``, :337)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._b1, self._b2 = beta1, beta2
        self._epsilon = epsilon

    def _init_state(self, param):
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param),
                "step": torch.zeros((), dtype=torch.float32,
                                    device=param.device)}

    def _update(self, p, g, state, lr, wd=None):
        g = _apply_l2(g, p, wd if wd is not None else self._weight_decay)
        t = state["step"] + 1
        m, v = state["moment1"], state["moment2"]
        m.mul_(self._b1).add_((1 - self._b1) * g)
        v.mul_(self._b2).add_((1 - self._b2) * g * g)
        m_hat = m / (1 - self._b1 ** t)
        rho_inf = 2.0 / (1 - self._b2) - 1
        rho_t = rho_inf - 2 * t * self._b2 ** t / (1 - self._b2 ** t)
        r = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf)
                       / torch.clamp((rho_inf - 4) * (rho_inf - 2) * rho_t,
                                     min=1e-12))
        v_hat = torch.sqrt(v / (1 - self._b2 ** t))
        adaptive = lr * r * m_hat / (v_hat + self._epsilon)
        sgd_like = lr * m_hat
        p.sub_(torch.where(rho_t > 5.0, adaptive, sgd_like))
        state["step"].copy_(t)


class ASGD(Optimizer):
    """Averaged SGD (``ASGD``, :371): the last ``batch_num`` gradients are
    kept and the step takes their running mean (d += g - y[i]; y[i] = g;
    p -= lr * d / n). The slot index stays on the device (``index_select``
    / ``index_copy_``), so a step never waits for the card."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._batch_num = max(int(batch_num), 1)

    def _init_state(self, param):
        n = self._batch_num
        return {"d": torch.zeros_like(param),
                "y": torch.zeros((n,) + tuple(param.shape),
                                 dtype=param.dtype, device=param.device),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=param.device)}

    def _update(self, p, g, state, lr, wd=None):
        g = _apply_l2(g, p, wd if wd is not None else self._weight_decay)
        n = self._batch_num
        step = state["step"]
        i = torch.remainder(step, n).reshape(1).long()
        y = state["y"]
        y_old = y.index_select(0, i)[0]
        d = state["d"]
        d.add_(g).sub_(y_old)
        y.index_copy_(0, i, g.unsqueeze(0))
        # until the window fills, average over the seen count
        seen = torch.clamp(step + 1, max=n).to(g.dtype)
        p.sub_(lr * d / seen)
        step.add_(1)


class Rprop(Optimizer):
    """Resilient backprop (``Rprop``, :402)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 etas=(0.5, 1.2), parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _init_state(self, param):
        return {"prev_grad": torch.zeros_like(param),
                "step_size": torch.full_like(param, float(self.get_lr()))}

    def _update(self, p, g, state, lr, wd=None):
        g = _apply_l2(g, p, wd if wd is not None else self._weight_decay)
        sign = torch.sign(g * state["prev_grad"])
        factor = torch.where(sign > 0, self._eta_pos,
                             torch.where(sign < 0, self._eta_neg, 1.0))
        step = torch.clamp(state["step_size"] * factor, self._lr_min,
                           self._lr_max)
        g_eff = torch.where(sign < 0, 0.0, g)
        p.sub_(torch.sign(g_eff) * step)
        state["prev_grad"].copy_(g_eff)
        state["step_size"].copy_(step)
