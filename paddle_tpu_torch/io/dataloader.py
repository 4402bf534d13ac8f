"""DataLoader (counterpart of ``paddle_tpu/io/dataloader.py``).

The reference's API and batches, in PyTorch's idiom:

- Samples are read and collated on the host. With ``num_workers > 0``
  the index batches come from this loader's ``batch_sampler`` and worker
  processes (``torch.utils.data.DataLoader``'s, kept across epochs with
  ``persistent_workers``) read and collate them; the JAX package's own
  fork pool and ``/dev/shm`` packing (:61-216) are not needed, since
  torch moves worker tensors through shared memory itself. A worker
  hands back plain CPU torch tensors: it never touches CUDA. Workers are
  forked (torch's default on Linux, and the JAX package's pool), so a
  dataset or ``worker_init_fn`` may be a lambda or a local class and the
  caller needs no ``__main__`` guard. A custom ``collate_fn`` runs in
  the main process on the worker's samples, as in the JAX package.
- Batches reach the caller as surface ``Tensor``s on the current place
  (``cuda:0`` unless ``set_device("cpu")``). The copy to the card is made
  in the main process: with ``use_buffer_reader`` (the reference's
  buffered reader, :344-378) from pinned memory with ``non_blocking=True``,
  keeping at most ``prefetch_factor`` batches in flight ahead of the
  consumer; without it, synchronously.
- Collation follows the JAX ``default_collate_fn`` (:38-58): tensors,
  arrays and numbers are stacked (float64 becomes the default float
  dtype, as the JAX ``Tensor`` does), lists, tuples and dicts recurse,
  strings stay lists.

A ``TensorDataset`` over tensors that are not on the CPU cannot be read
by worker processes; ``num_workers > 0`` then raises ``ValueError``
before any worker starts.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ..core.tensor import Tensor, _from_numpy
from .dataset import IterableDataset, TensorDataset
from .sampler import BatchSampler


def get_worker_info():
    """The worker's ``(id, num_workers, seed, dataset)`` inside a worker
    process, None in the main process."""
    return torch.utils.data.get_worker_info()


def _host_array(a: np.ndarray) -> torch.Tensor:
    t = _from_numpy(a)
    if t.dtype == torch.float64:
        t = t.to(dtype_mod.default_float_dtype().torch_dtype)
    return t


def _collate_host(batch):
    """The JAX ``default_collate_fn`` on the host: nested lists, tuples
    and dicts of stacked torch tensors (a batch of surface ``Tensor``s is
    stacked where its rows live)."""
    sample = batch[0]
    if isinstance(sample, (Tensor, torch.Tensor)):
        return torch.stack([s._data if isinstance(s, Tensor) else s
                            for s in batch])
    if isinstance(sample, np.ndarray):
        return _host_array(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return _host_array(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return [_collate_host(list(items)) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: _collate_host([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (str, bytes)):
        return list(batch)
    raise TypeError(f"cannot collate type {type(sample)}")


def _to_host(obj):
    """Surface Tensors -> their torch tensors (what a worker returns)."""
    if isinstance(obj, Tensor):
        return obj._data
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _host_samples(batch):
    """A worker's collate for a custom ``collate_fn``: the samples as they
    are, surface Tensors as torch tensors (the main process collates)."""
    return [_to_host(s) for s in batch]


def _from_host(obj):
    """torch tensors -> surface Tensors (the main process's side of
    ``_host_samples``)."""
    if isinstance(obj, torch.Tensor):
        return Tensor._from_data(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _from_host(v) for k, v in obj.items()}
    return obj


def _stage(obj, device, non_blocking):
    """Every tensor of ``obj`` as a surface Tensor on ``device`` (a copy
    from pinned memory when ``non_blocking``); anything else as it is."""
    if isinstance(obj, (Tensor, torch.Tensor)):
        sg = obj.stop_gradient if isinstance(obj, Tensor) else True
        t = (obj._data if isinstance(obj, Tensor) else obj).detach()
        if t.device != device:
            if non_blocking and t.device.type == "cpu" and \
                    device.type == "cuda":
                t = t.pin_memory()
            t = t.to(device, non_blocking=non_blocking)
        out = Tensor._from_data(t)
        out.stop_gradient = sg
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_stage(o, device, non_blocking) for o in obj)
    if isinstance(obj, dict):
        return {k: _stage(v, device, non_blocking) for k, v in obj.items()}
    return obj


def default_collate_fn(batch):
    """Stack samples into batch Tensors on the current place."""
    return _stage(_collate_host(batch), place_mod.current_device(), False)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self._default_collate = collate_fn is None
        self.num_workers = int(num_workers)
        self.prefetch_factor = max(int(prefetch_factor), 1)
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = bool(use_shared_memory)
        self.use_buffer_reader = bool(use_buffer_reader)
        self.persistent_workers = bool(persistent_workers)
        self.timeout = timeout
        #: the persistent workers' torch loader (made on first use)
        self._workers: Optional[torch.utils.data.DataLoader] = None
        self._iterable_ds = isinstance(dataset, IterableDataset)
        if self._iterable_ds:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        elif batch_size is None:
            # batch_size None = no auto-batching
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable_ds:
            raise TypeError("IterableDataset has no length")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _collate(self, samples):
        if self._default_collate:
            return _collate_host(samples)
        return self.collate_fn(samples)

    def _iter_iterable(self):
        buf = []
        for sample in self.dataset:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._collate(buf)

    def _iter_single(self):
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
            return
        for indices in self.batch_sampler:
            yield self._collate([self.dataset[i] for i in indices])

    def _check_host_dataset(self):
        if isinstance(self.dataset, TensorDataset):
            tensors = [_to_host(t) for t in self.dataset.tensors]
            off = sorted({str(t.device) for t in tensors
                          if isinstance(t, torch.Tensor) and
                          t.device.type != "cpu"})
            if off:
                raise ValueError(
                    f"num_workers={self.num_workers}: worker processes read "
                    f"samples on the CPU and cannot read a TensorDataset "
                    f"whose tensors live on {off}; build it from CPU "
                    f"tensors (place='cpu') or numpy arrays, or use "
                    f"num_workers=0")

    def _torch_loader(self):
        return torch.utils.data.DataLoader(
            self.dataset, batch_sampler=self.batch_sampler,
            collate_fn=_collate_host if self._default_collate
            else _host_samples,
            num_workers=self.num_workers, timeout=self.timeout,
            worker_init_fn=self.worker_init_fn,
            prefetch_factor=self.prefetch_factor,
            persistent_workers=self.persistent_workers)

    def _iter_workers(self):
        self._check_host_dataset()
        if self.persistent_workers:
            if self._workers is None:
                self._workers = self._torch_loader()
            loader = self._workers
        else:
            loader = self._torch_loader()
        for item in loader:
            yield item if self._default_collate else \
                self.collate_fn(_from_host(item))

    def _staged(self, it):
        """``it``'s batches as surface Tensors on the current place; with
        ``use_buffer_reader`` each batch's copy is issued (pinned,
        non-blocking) as soon as it is read, at most ``prefetch_factor``
        batches ahead of the one handed out."""
        device = place_mod.current_device()
        if not self.use_buffer_reader:
            for item in it:
                yield _stage(item, device, False)
            return
        buf = collections.deque()
        try:
            for item in it:
                buf.append(_stage(item, device, True))
                if len(buf) >= self.prefetch_factor:
                    yield buf.popleft()
            while buf:
                yield buf.popleft()
        finally:
            buf.clear()

    def __iter__(self):
        if self._iterable_ds:
            it = self._iter_iterable()
        elif self.num_workers > 0 and self.batch_sampler is not None:
            it = self._iter_workers()
        else:
            it = self._iter_single()
        return self._staged(it)

    def __call__(self):
        return self.__iter__()
