"""Learning-rate schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``).

The port's own copy of the JAX package's module: the ``LRScheduler``
base and its seventeen schedules, plain Python on floats that touches no
tensor. A scheduler is a callable returning the current lr; ``step()``
advances its epoch or step count. An optimizer built with one reads it
in ``get_lr()``, and ``TrainStep`` reads ``get_lr()`` at every call, so
a schedule drives both the eager step and the train step unchanged.
``state_dict`` / ``set_state_dict`` carry the scheduler's scalar fields
(``Optimizer.state_dict`` stores them under ``@lr_state``).
"""
from __future__ import annotations


import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = float(learning_rate)
        self.verbose = verbose
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state):
        self.__dict__.update(state)

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(step / self.decay_steps) if step > 0 else 1
            decay_steps = self.decay_steps * max(div, 1)
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * \
            ((1 - step / decay_steps) ** self.power) + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        init = learning_rate.base_lr if isinstance(
            learning_rate, LRScheduler) else float(learning_rate)
        super().__init__(init, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * \
                self.last_epoch / self.warmup_steps + self.start_lr
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.step(self.last_epoch - self.warmup_steps)
            return self.lr_after()
        return float(self.lr_after)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (
            self.gamma ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        self._cum = 1.0
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cum *= self.lr_lambda(self.last_epoch)
        return self.base_lr * self._cum


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0,
                 last_epoch=-1, verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        e = max(self.last_epoch, 0)
        t_i = self.T_0
        while e >= t_i:
            e -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * e / t_i)) / 2


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return start + (end - start) * pct

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        up = int(self.phase_pct * self.total_steps)
        if step <= up and up > 0:
            return self._interp(self.initial_lr, self.max_lr, step / up)
        down = self.total_steps - up
        pct = (step - up) / max(down, 1)
        return self._interp(self.max_lr, self.end_lr, pct)


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = float(learning_rate)
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def _better(self, a, b):
        if b is None:
            return True
        if self.mode == "min":
            thr = b * (1 - self.threshold) \
                if self.threshold_mode == "rel" else b - self.threshold
            return a < thr
        thr = b * (1 + self.threshold) \
            if self.threshold_mode == "rel" else b + self.threshold
        return a > thr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        # a tensor on any device, a numpy scalar or a float
        m = float(metrics.item()) if hasattr(metrics, "item") \
            else float(metrics)
        self.last_epoch += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self._better(m, self.best):
            self.best = m
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up=2000, step_size_down=None, mode="triangular",
                 exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.up + self.down
        cycle = self.last_epoch // total
        pos = self.last_epoch % total
        if pos < self.up:
            pct = pos / self.up
        else:
            pct = 1 - (pos - self.up) / self.down
        amp = (self.max_lr - self.base_lr) * pct
        if self.mode == "triangular2":
            amp = amp / (2 ** cycle)
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** self.last_epoch)
        return self.base_lr + amp


class LinearLR(LRScheduler):
    """Linear interpolation from start_factor to end_factor over
    total_steps (reference: optimizer/lr.py LinearLR)."""

    def __init__(self, learning_rate, total_steps, start_factor=1. / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        if total_steps <= 0:
            raise ValueError("total_steps must be positive")
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = min(max(self.last_epoch, 0), self.total_steps)
        factor = self.start_factor + (
            self.end_factor - self.start_factor) * t / self.total_steps
        return self.base_lr * factor
