"""Dynamic loss scaling (counterpart of ``paddle_tpu/amp/grad_scaler.py``).

Scale the loss, unscale the gradients before the step, skip the step
when a gradient holds an inf or a NaN, and grow or shrink the scale on a
schedule (``incr_every_n_steps`` good steps multiply it by
``incr_ratio``; ``decr_every_n_nan_or_inf`` bad ones by ``decr_ratio``,
never below 1). It works over any of the port's optimizers and their
parameter groups.

One divergence by design: the JAX ``unscale_`` reads each gradient's
finiteness on the host, one sync a gradient (:69-83); the port reduces
every gradient's flag on the device and syncs once. The skip decisions,
the scale trajectory and the unscaled gradients are the same.
"""
from __future__ import annotations

from enum import Enum

import torch


class OptimizerState(Enum):
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._opt_states = {}

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def scale(self, var):
        """``var`` times the scale, the scale first rounded to ``var``'s
        dtype (as the JAX package multiplies by an array of that dtype);
        a surface Tensor comes back as one, its graph kept."""
        if not self._enable:
            return var
        from ..core.tensor import Tensor
        if isinstance(var, Tensor):
            return Tensor._from_data(self.scale(var._data))
        return var * torch.tensor(self._scale, dtype=var.dtype,
                                  device=var.device)

    @staticmethod
    def _collect_params(optimizer):
        params = []
        for p in optimizer._parameter_list or []:
            if isinstance(p, dict):
                params.extend(p.get("params", []))
            else:
                params.append(p)
        return params

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every gradient by 1 / scale and record whether any
        holds an inf or a NaN (one host sync for all of them)."""
        if not self._enable:
            return
        if self._opt_states.get(id(optimizer)) == OptimizerState.UNSCALED:
            return
        inv = 1.0 / self._scale
        grads = [p.grad for p in self._collect_params(optimizer)
                 if p.grad is not None]
        flags = [torch.isfinite(g).all() for g in grads]
        for g in grads:
            g.mul_(inv)
        self._found_inf = bool(flags) and not bool(
            torch.stack([f.to(flags[0].device) for f in flags]).all())
        self._opt_states[id(optimizer)] = OptimizerState.UNSCALED

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if self._opt_states.get(id(optimizer)) != OptimizerState.UNSCALED:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._opt_states[id(optimizer)] = OptimizerState.STEPPED

    def update(self):
        if not self._enable or not self._use_dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._opt_states.clear()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
            "use_dynamic_loss_scaling": self._use_dynamic,
        } if self._enable else {}

    def load_state_dict(self, state):
        if not self._enable or not state:
            return
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)

    def get_incr_ratio(self):
        return self._incr_ratio

    def get_decr_ratio(self):
        return self._decr_ratio


AmpScaler = GradScaler
