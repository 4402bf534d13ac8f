"""Metrics (counterpart of ``paddle_tpu/metric/__init__.py``).

``Accuracy.compute`` and ``accuracy`` run on the device of their inputs
(surface ``Tensor``s or raw torch tensors): the top-k of the predictions
against the labels, one small tensor back. ``update`` and ``accumulate``
keep the JAX package's host accumulators (Python floats and numpy
arrays), reading their inputs once to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor, to_numpy


def _np(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return np.asarray(x)


def _torch(x, device=None):
    if isinstance(x, Tensor):
        return x._data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(np.asarray(x), device=device)


def _topk_hits(pred, label, k):
    """[n, k] bool: whether each of a row's k best predictions is its
    label (the JAX ``argsort(-pred)[:, :k] == label``)."""
    top = torch.topk(pred, k, dim=-1).indices
    return top == label.reshape(-1, 1).to(top.dtype)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy (reference: metric/metrics.py Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """[n, maxk] float32 Tensor on the predictions' device: 1 where
        the j-th best prediction is the label (a one-hot label is taken
        by its argmax)."""
        p = _torch(pred)
        lab = _torch(label, p.device)
        if lab.dim() == p.dim() and lab.shape[-1] != 1:
            lab = torch.argmax(lab, dim=-1)
        lab = lab.reshape(lab.shape[0], -1)[:, 0]
        return Tensor._from_data(_topk_hits(p, lab, self.maxk).float())

    def update(self, correct, *args):
        c = _np(correct)
        out = []
        for i, k in enumerate(self.topk):
            num = float(c[:, :k].sum())
            self.total[i] += num
            self.count[i] += c.shape[0]
            out.append(num / max(c.shape[0], 1))
        return out[0] if len(out) == 1 else out

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    """Trapezoidal AUC over thresholded bins (reference metrics.py Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        n = self.num_thresholds + 1
        self._stat_pos = np.zeros(n)
        self._stat_neg = np.zeros(n)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        lab = _np(labels).reshape(-1)
        bins = np.minimum((p * self.num_thresholds).astype(np.int64),
                          self.num_thresholds)
        pos = lab.astype(bool)
        np.add.at(self._stat_pos, bins[pos], 1)
        np.add.at(self._stat_neg, bins[~pos], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # from the highest threshold down
        tp = fp = 0.0
        area = 0.0
        prev_tp = prev_fp = 0.0
        for i in range(self.num_thresholds, -1, -1):
            tp += self._stat_pos[i]
            fp += self._stat_neg[i]
            area += (fp - prev_fp) * (tp + prev_tp) / 2.0
            prev_tp, prev_fp = tp, fp
        return float(area / (tot_pos * tot_neg))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy (paddle.metric.accuracy): a float32
    0-d Tensor on the input's device."""
    p = _torch(input)
    hit = _topk_hits(p, _torch(label, p.device).reshape(-1), k).any(dim=1)
    return Tensor._from_data(hit.float().mean())


__all__ = ["Accuracy", "Auc", "Metric", "Precision", "Recall", "accuracy"]
