"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``).

The same callbacks firing at the same points. ``CallbackList`` adds a
``TelemetryLogger`` when ``monitor.enabled()`` (``PADDLE_TPU_MONITOR=1``
or ``monitor.enable()``); its recompiles are what the port builds or
captures at run time (kernel libraries, CUDA graphs), where the JAX
package counts XLA compiles.
"""
from __future__ import annotations

import time

from .. import monitor


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None, model=None, **params):
        self.callbacks = list(callbacks or [])
        if params.get("verbose", 2) and not any(
                isinstance(c, ProgBarLogger) for c in self.callbacks):
            self.callbacks.insert(0, ProgBarLogger(
                log_freq=params.get("log_freq", 10),
                verbose=params.get("verbose", 2)))
        if monitor.enabled() and not any(
                isinstance(c, TelemetryLogger) for c in self.callbacks):
            self.callbacks.append(TelemetryLogger())
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call(f"on_{mode}_batch_begin", step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call(f"on_{mode}_batch_end", step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_begin(self, mode, logs=None):
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._epoch_t0 = time.time()
        self._samples = 0

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            msg = " - ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                             if isinstance(v, (int, float)))
            total = f"/{self.steps}" if self.steps else ""
            print(f"Epoch {self.epoch + 1} step {step}{total}: {msg}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._epoch_t0
            msg = " - ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                             if isinstance(v, (int, float)))
            print(f"Epoch {epoch + 1} done ({dt:.1f}s): {msg}")


class TelemetryLogger(Callback):
    """Per-epoch telemetry through the ``monitor`` registry: step times
    measured here (``train.steps``, ``train.step_ms``), and the kernel
    builds and CUDA graph captures of the epoch (the always-on counters
    that ``profiler/stats.py`` feeds). Each epoch one line like

        [telemetry] epoch 1: steps 50 avg_step_ms 12.4 (min 11.0 max
        31.2) recompiles 0 compile_s 0.00
    """

    def __init__(self, verbose=1):
        super().__init__()
        self.verbose = verbose
        self.last_line = None

    def _compiles(self):
        from ..profiler.stats import COMPILE_COUNTERS
        return (sum(monitor.counter(c).get()
                    for c, _ in COMPILE_COUNTERS.values()),
                sum(monitor.gauge(g).get()
                    for _, g in COMPILE_COUNTERS.values()))

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._steps = 0
        self._dt_total = 0.0
        self._dt_min = float("inf")
        self._dt_max = 0.0
        self._compiles0 = self._compiles()

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        dt = time.perf_counter() - getattr(self, "_t0", time.perf_counter())
        self._steps += 1
        self._dt_total += dt
        self._dt_min = min(self._dt_min, dt)
        self._dt_max = max(self._dt_max, dt)
        monitor.counter("train.steps").increase()
        monitor.gauge("train.step_ms").set(dt * 1e3)

    def on_epoch_end(self, epoch, logs=None):
        if not getattr(self, "_steps", 0):
            return
        c1, s1 = self._compiles()
        c0, s0 = self._compiles0
        avg = self._dt_total / self._steps * 1e3
        monitor.gauge("train.epoch_recompiles").set(c1 - c0)
        self.last_line = (
            f"[telemetry] epoch {epoch + 1}: steps {self._steps} "
            f"avg_step_ms {avg:.1f} (min {self._dt_min * 1e3:.1f} "
            f"max {self._dt_max * 1e3:.1f}) "
            f"recompiles {c1 - c0} compile_s {s1 - s0:.2f}")
        if self.verbose:
            print(self.last_line)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.verbose = verbose
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        # prefer the eval metric (same rationale as ReduceLROnPlateau:
        # the reference stops on eval, not the noisy last train batch)
        cur = (logs or {}).get(f"eval_{self.monitor}",
                               (logs or {}).get(self.monitor))
        if cur is None:
            return
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping at epoch {epoch + 1}")


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class ReduceLROnPlateau(Callback):
    """Reduce LR when a monitored metric stops improving (reference:
    hapi/callbacks.py ReduceLROnPlateau)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10,
                 verbose=1, mode="auto", min_delta=1e-4, cooldown=0,
                 min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "auto":
            mode = "min" if "acc" not in monitor else "max"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        self._check(logs or {})

    def _check(self, logs):
        # eval metrics surface in epoch logs with an eval_ prefix;
        # prefer them (the reference monitors eval, not the last train
        # batch) and fall back to the raw key for train-only fits
        cur = logs.get("eval_" + self.monitor, logs.get(self.monitor))
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self.cooldown_counter > 0:
            # in cooldown: no wait accumulation, no reductions
            self.cooldown_counter -= 1
            self.wait = 0
            if self._better(cur):
                self.best = cur
            return
        if self._better(cur):
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            changed = False
            if opt is not None and hasattr(opt, "_learning_rate") and \
                    not hasattr(opt._learning_rate, "step"):
                lr = opt.get_lr()
                new_lr = max(lr * self.factor, self.min_lr)
                if new_lr < lr:
                    opt._learning_rate = new_lr
                    changed = True
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr {lr:g} -> "
                              f"{new_lr:g}")
            if changed:
                self.cooldown_counter = self.cooldown
                self.wait = 0


class VisualDL(Callback):
    """VisualDL logging (reference: hapi/callbacks.py VisualDL). Without
    the visualdl package, constructing the callback raises the
    ImportError the reference raises."""

    def __init__(self, log_dir="vdl_log"):
        raise ImportError(
            "VisualDL is not installed; pip install visualdl to use this "
            "callback (scalar logs are also written by ProgBarLogger)")


class WandbCallback(Callback):
    """Weights & Biases logging (reference: hapi/callbacks.py
    WandbCallback); requires the external wandb package."""

    def __init__(self, *a, **kw):
        raise ImportError(
            "wandb is not installed; pip install wandb to use this "
            "callback")
