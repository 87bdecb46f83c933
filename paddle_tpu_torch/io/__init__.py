"""Datasets, samplers and the DataLoader (``paddle_tpu/io``), with
``num_workers=0``. Not ported (ROADMAP queue A): worker threads and
processes and ``prefetch.py``."""
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, random_split,
)
from .reader import DataLoader, default_collate_fn  # noqa: F401
from .sampler import (  # noqa: F401
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, WeightedRandomSampler,
)

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "ConcatDataset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "DataLoader",
           "default_collate_fn"]
