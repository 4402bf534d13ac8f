"""hapi — the paddle.Model high-level training API (counterpart of
``paddle_tpu/hapi/model.py``).

The JAX package's one adapter: ``prepare`` builds a ``jit.TrainStep``
(O1 and O2 both map to bf16, :49-54) and falls back to the eager loop
when that raises (:56-61); ``Model._train_step`` tells which ran. The
network is a surface ``Layer`` or a raw ``torch.nn.Module`` of the
port's model families: a Layer takes and returns surface ``Tensor``s, a
Module torch tensors (the DataLoader's Tensors are unwrapped for it).
Losses come back as Python floats (``.item()``), one host read a step as
in the JAX package's ``train_batch``; metrics see the network's outputs
as they come. ``evaluate`` and ``predict`` run the network itself, in
its dtype, after ``sync_to_model``; ``save`` / ``load`` go through
``framework/io.py`` (``.pdparams``, ``.pdopt``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.tensor import Tensor, to_numpy
from ..io import DataLoader
from ..jit.api import TrainStep, _is_layer
from ..metric import Metric
from .callbacks import CallbackList


def _host_float(x):
    t = x._data if isinstance(x, Tensor) else x
    return float(t.item()) if isinstance(t, torch.Tensor) else float(t)


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._optimizer = None
        self._metrics: List[Metric] = []
        self._train_step: Optional[TrainStep] = None
        self._layer = _is_layer(network)
        self.stop_training = False

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
            for m in metrics:
                if not isinstance(m, Metric):
                    raise TypeError(
                        f"metric should be an instance of paddle.metric."
                        f"Metric, got {type(m).__name__} (reference "
                        "hapi/model.py prepare has the same check)")
            self._metrics = list(metrics)
        amp_dtype = None
        if amp_configs:
            level = amp_configs.get("level", "O0") \
                if isinstance(amp_configs, dict) else str(amp_configs)
            if level in ("O1", "O2"):
                amp_dtype = torch.bfloat16
        self._train_step = None
        if optimizer is not None and loss is not None:
            try:
                self._train_step = TrainStep(self.network, loss, optimizer,
                                             amp_dtype=amp_dtype)
            except Exception:  # noqa: BLE001 — the reference's fallback
                self._train_step = None

    def inspect(self, inputs=None, labels=None, mesh=None):
        raise NotImplementedError(
            "Model.inspect lints the compiled program: it comes with the "
            "analysis slice of the port (ROADMAP section 1, item 6)")

    # -- the network on a batch ----------------------------------------------
    def _forward(self, inputs):
        if self._layer:
            args = [x if isinstance(x, Tensor) else Tensor(x)
                    for x in inputs]
        else:
            args = [x._data if isinstance(x, Tensor) else x
                    for x in inputs]
        return self.network(*args)

    def _labels_for_loss(self, labels):
        if self._layer or labels is None:
            return labels
        if isinstance(labels, (list, tuple)):
            return type(labels)(self._labels_for_loss(x) for x in labels)
        return labels._data if isinstance(labels, Tensor) else labels

    # -- single-batch APIs ---------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        if self._train_step is not None:
            loss = self._train_step(tuple(inputs), labels)
            return [_host_float(loss)]
        out = self._forward(inputs)
        loss = self._loss(out, self._labels_for_loss(labels))
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [_host_float(loss)]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        if self._train_step is not None:
            self._train_step.sync_to_model()
        with torch.no_grad():
            out = self._forward(inputs)
            metrics_out = []
            if self._loss is not None and labels is not None:
                metrics_out.append(_host_float(self._loss(
                    out, self._labels_for_loss(labels))))
        self._update_metrics(out, labels)
        return metrics_out

    def predict_batch(self, inputs):
        self.network.eval()
        if self._train_step is not None:
            self._train_step.sync_to_model()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        with torch.no_grad():
            return self._forward(inputs)

    # -- loops ---------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None):
        train_loader = self._to_loader(train_data, batch_size, shuffle,
                                       drop_last, num_workers)
        eval_loader = self._to_loader(eval_data, batch_size, False, False,
                                      num_workers) if eval_data is not None \
            else None
        cbks = CallbackList(callbacks, model=self, verbose=verbose,
                            epochs=epochs,
                            steps=self._safe_len(train_loader),
                            metrics=self._metric_names())
        cbks.on_begin("train")
        iters_done = 0
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            self.network.train()
            logs = {}
            for step, batch in enumerate(train_loader):
                cbks.on_batch_begin("train", step, logs)
                ins, labs = self._split_batch(batch)
                losses = self.train_batch(ins, labs)
                logs = {"loss": losses[0], "step": step}
                if self._lr_scheduler() is not None:
                    self._lr_scheduler().step()
                cbks.on_batch_end("train", step, logs)
                iters_done += 1
                if num_iters is not None and iters_done >= num_iters:
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0,
                                          _inner=True)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
        cbks.on_end("train", logs)
        if self._train_step is not None:
            self._train_step.sync_to_model()
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None,
                 _inner=False):
        loader = self._to_loader(eval_data, batch_size, False, False,
                                 num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        self.network.eval()
        if self._train_step is not None:
            self._train_step.sync_to_model()
        for batch in loader:
            ins, labs = self._split_batch(batch)
            with torch.no_grad():
                out = self._forward(ins)
                if self._loss is not None and labs is not None:
                    losses.append(_host_float(self._loss(
                        out, self._labels_for_loss(labs))))
            self._update_metrics(out, labs)
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            for n, v in zip(names, vals):
                logs[n] = v
        if verbose and not _inner:
            print("Eval:", " - ".join(f"{k}: {v:.4f}"
                                      for k, v in logs.items()))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = self._to_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        self.network.eval()
        if self._train_step is not None:
            self._train_step.sync_to_model()
        for batch in loader:
            ins, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            flat = [o.numpy() if isinstance(o, Tensor) else
                    to_numpy(o) if isinstance(o, torch.Tensor) else o
                    for o in outputs]
            return [np.concatenate(flat, axis=0)]
        return outputs

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        from ..framework.io import save as fsave
        if self._train_step is not None:
            self._train_step.sync_to_model()
        fsave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as fload
        sd = fload(path + ".pdparams")
        if self._layer:
            self.network.set_state_dict(sd)
        else:                       # copies into the module's tensors
            self.network.load_state_dict({k: v._data for k, v in
                                          sd.items()})
        osd = None
        if not reset_optimizer and self._optimizer is not None:
            try:
                osd = fload(path + ".pdopt")
            except FileNotFoundError:
                pass
        if osd is not None:
            self._optimizer.set_state_dict(
                {k: v._data if isinstance(v, Tensor) else v
                 for k, v in osd.items()})
        if self._train_step is not None:
            self._train_step.sync_from_model()
            if osd is not None:
                # the train step updates the loaded state from here on
                self._train_step.opt_state = {
                    n: self._optimizer._state_for(p)
                    for n, p in self._train_step._params.items()}
        return self

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters(*args, **kwargs))

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)

    # -- helpers -------------------------------------------------------------
    def _update_metrics(self, out, labels):
        """Each network output and each label is a separate positional
        argument of ``Metric.compute`` (reference hapi/model.py)."""
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        labs = (list(labels) if isinstance(labels, (list, tuple))
                else ([] if labels is None else [labels]))
        for m in self._metrics:
            m.update(m.compute(*outs, *labs))

    def _lr_scheduler(self):
        if self._optimizer is None:
            return None
        return getattr(self._optimizer, "_lr_scheduler", None)

    def _metric_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    @staticmethod
    def _safe_len(loader):
        try:
            return len(loader)
        except TypeError:
            return None

    @staticmethod
    def _to_loader(data, batch_size, shuffle, drop_last, num_workers):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) == 1:
                return [batch[0]], None
            return list(batch[:-1]), batch[-1]
        return [batch], None
