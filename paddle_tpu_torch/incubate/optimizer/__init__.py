"""Incubate optimizer wrappers (counterpart of
``paddle_tpu/incubate/optimizer/__init__.py``): ``LookAhead`` (:10) and
``ModelAverage`` (:58) over the port's optimizers, ``LBFGS`` re-exported,
and ``functional`` (``minimize_bfgs`` / ``minimize_lbfgs``).

The port's optimizers update leaf torch tensors in place, and so do
these: the slow weights and the averaged weights are copied into the
leaves (under ``torch.no_grad()``), never rebound, so the inner
optimizer keeps holding its parameters.
"""
from __future__ import annotations

import torch

from ...core.dispatch import unwrap
from ...optimizer import LBFGS  # noqa: F401  (reference re-export)

__all__ = ["LookAhead", "ModelAverage", "LBFGS", "functional"]


class LookAhead:
    """k fast steps of the inner optimizer, then the slow weights move
    ``alpha`` of the way to the fast ones and the fast weights take their
    value. As in the JAX package, the slow weights start as the fast
    weights at the first synchronisation."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step = 0
        self._slow = {}

    @property
    def _parameter_list(self):
        return self.inner_optimizer._parameter_list

    def step(self):
        self.inner_optimizer.step()
        self._step += 1
        if self._step % self.k:
            return
        with torch.no_grad():
            for p in self._parameter_list:
                if not p.requires_grad:
                    continue
                slow = self._slow.get(id(p))
                if slow is None:
                    slow = p.detach().clone()
                slow = slow + self.alpha * (p - slow)
                self._slow[id(p)] = slow
                p.copy_(slow)

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()

    def clear_grad(self, **kw):
        self.inner_optimizer.clear_grad(**kw)

    clear_gradients = clear_grad

    def state_dict(self):
        return self.inner_optimizer.state_dict()

    def set_state_dict(self, sd):
        return self.inner_optimizer.set_state_dict(sd)

    def get_lr(self):
        return self.inner_optimizer.get_lr()


class ModelAverage:
    """A running sum of the parameters over a window of steps; ``apply()``
    swaps the averages in (a context manager, restoring on exit unless
    ``need_restore=False``) and ``restore()`` swaps the weights back. The
    window restarts after ``max_average_window`` steps."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self.average_window_rate = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._parameter_list = [unwrap(p) for p in (parameters or [])]
        self._sums = {id(p): torch.zeros_like(p)
                      for p in self._parameter_list}
        self._counts = {id(p): 0 for p in self._parameter_list}
        self._backup = {}

    @torch.no_grad()
    def step(self):
        for p in self._parameter_list:
            key = id(p)
            if self._counts[key] >= self.max_average_window:
                self._sums[key].zero_()
                self._counts[key] = 0
            self._sums[key] += p
            self._counts[key] += 1

    def apply(self, executor=None, need_restore=True):
        outer = self

        class _Ctx:
            def __enter__(ctx):
                with torch.no_grad():
                    for p in outer._parameter_list:
                        key = id(p)
                        if outer._counts[key] == 0:
                            continue
                        outer._backup[key] = p.detach().clone()
                        p.copy_((outer._sums[key] / outer._counts[key]
                                 ).to(p.dtype))
                return ctx

            def __exit__(ctx, *exc):
                if need_restore:
                    outer.restore()
                return False
        return _Ctx()

    @torch.no_grad()
    def restore(self, executor=None):
        for p in self._parameter_list:
            backup = self._backup.pop(id(p), None)
            if backup is not None:
                p.copy_(backup)

    def minimize(self, loss, **kw):
        self.step()


from . import functional  # noqa: F401,E402
