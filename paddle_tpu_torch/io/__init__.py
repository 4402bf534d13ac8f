"""paddle.io of the port (counterpart of ``paddle_tpu/io``): datasets,
samplers and the ``DataLoader``, whose batches are surface ``Tensor``s
on the current place."""
from .dataloader import DataLoader, default_collate_fn, get_worker_info
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset",
           "ConcatDataset", "DataLoader", "Dataset",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "Sampler", "SequenceSampler", "Subset", "SubsetRandomSampler",
           "TensorDataset", "WeightedRandomSampler", "default_collate_fn",
           "get_worker_info", "random_split"]
