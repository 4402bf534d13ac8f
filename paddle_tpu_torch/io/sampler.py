"""Samplers (counterpart of ``paddle_tpu/io/sampler.py``).

The index streams are the JAX package's, draw for draw: a sampler given a
``generator`` draws from ``np.random.default_rng(generator.
initial_seed())`` (a ``torch.Generator`` has ``initial_seed`` too), one
without from fresh entropy, and ``DistributedBatchSampler`` shuffles with
``default_rng(epoch)``, pads to a multiple of the ranks and strides by
rank. So one seed gives both packages the same batches.
"""
from __future__ import annotations

import os

import numpy as np


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


def _rng(generator):
    return np.random.default_rng(
        generator.initial_seed() if generator is not None else None)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = _rng(self.generator)
        if self.replacement:
            yield from rng.integers(0, n, self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[:self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = np.random.default_rng()
        yield from rng.choice(len(self.weights), self.num_samples,
                              replace=self.replacement, p=p).tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        rng = _rng(self.generator)
        yield from (self.indices[i]
                    for i in rng.permutation(len(self.indices)))

    def __len__(self):
        return len(self.indices)


def _batches(indices, batch_size, drop_last):
    batch = []
    for idx in indices:
        batch.append(idx)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            assert dataset is not None
            sampler = RandomSampler(dataset) if shuffle \
                else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)
        self.shuffle = shuffle

    def __iter__(self):
        return _batches(self.sampler, self.batch_size, self.drop_last)

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    """(world size, rank): the initialized ``torch.distributed`` group's,
    else ``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ID``, else (1, 0)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return (int(os.environ.get("PADDLE_TRAINERS_NUM", 1)),
            int(os.environ.get("PADDLE_TRAINER_ID", 0)))


class DistributedBatchSampler(BatchSampler):
    """Shards the index stream by rank: padded to a multiple of the ranks
    (with the stream's first indices), then every ``nranks``-th index from
    ``rank`` on."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, my_rank = _world()
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = bool(drop_last)
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else my_rank
        self.epoch = 0
        n = len(dataset)
        if drop_last:
            self.num_samples = n // self.nranks
        else:
            self.num_samples = (n + self.nranks - 1) // self.nranks
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.default_rng(self.epoch).permutation(
                n).tolist()
        else:
            indices = list(range(n))
        if not self.drop_last and len(indices) < self.total_size:
            indices += indices[: self.total_size - len(indices)]
        indices = indices[: self.total_size]
        return _batches(indices[self.local_rank::self.nranks],
                        self.batch_size, self.drop_last)

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
