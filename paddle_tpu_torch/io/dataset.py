"""Datasets (counterpart of ``paddle_tpu/io/dataset.py``).

The same classes with the same semantics. ``TensorDataset`` indexes the
tensors it holds without a surface op: a sample of a surface ``Tensor``
is a ``Tensor`` view of its row, a sample of a numpy array or a torch
tensor is its row as it is. ``random_split`` draws its permutation from
``np.random.default_rng(generator.initial_seed())``, as the JAX package
does, so one seed splits both packages' datasets alike.
"""
from __future__ import annotations

import bisect

import numpy as np

from ..core.tensor import Tensor


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __getitem__")

    def __len__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __len__")


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __iter__")

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


def _row(t, idx):
    if isinstance(t, Tensor):
        return Tensor._from_data(t._data[idx])
    return t[idx]


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lens = {t.shape[0] for t in tensors}
        assert len(lens) == 1, "tensors must share dim 0"
        self.tensors = list(tensors)

    def __getitem__(self, idx):
        return tuple(_row(t, idx) for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        lens = {len(d) for d in self.datasets}
        assert len(lens) == 1

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        i = bisect.bisect_right(self.cum, idx)
        prev = self.cum[i - 1] if i > 0 else 0
        return self.datasets[i][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    rng = np.random.default_rng(
        generator.initial_seed() if generator is not None else None)
    perm = rng.permutation(len(dataset)).tolist()
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n]))
        off += n
    return out
