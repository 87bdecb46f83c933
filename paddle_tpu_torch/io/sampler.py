"""Samplers: ``paddle_tpu/io/sampler.py``. Shuffles draw from
``np.random`` (or the numpy ``generator`` given) exactly as the
reference does, so a run seeded with ``np.random.seed`` visits the
batches in the same order on both; ``DistributedBatchSampler`` shuffles
with ``np.random.RandomState(epoch)``, as the reference, index for
index."""
from __future__ import annotations

import math

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
        rng = self.generator or np.random
        if self.replacement:
            draw = getattr(rng, "integers", None) or rng.randint
            yield from draw(0, n, size=self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[: self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__()
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(
            len(self.weights), size=self.num_samples,
            replace=self.replacement, p=p,
        )
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Yields lists of indices (reference `batch_sampler.py:20`)."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = int(batch_size)
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """This rank's shard of the index space (Paddle's
    ``python/paddle/io/dataloader/batch_sampler.py``): the indices
    (shuffled by ``np.random.RandomState(epoch)`` under ``shuffle``) are
    padded with their own head to a multiple of ``num_replicas``, so
    every rank sees the same number of batches (collectives run in
    lockstep), then strided by rank. ``num_replicas`` and ``rank``
    default to the world size and rank of ``paddle_tpu_torch.
    distributed``; ``set_epoch`` reseeds the shuffle."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from ..distributed import get_rank, get_world_size

            num_replicas = num_replicas or get_world_size()
            rank = rank if rank is not None else get_rank()
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(indices)
        indices = indices.tolist()
        indices += indices[:self.total_size - len(indices)]
        batch = []
        for idx in indices[self.local_rank:self.total_size:self.nranks]:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
