"""DataLoader (counterpart of ``paddle_tpu/io/reader.py`` with
``num_workers=0``).

Batches are collated as the reference collates them
(``default_collate_fn``: numpy samples stacked) and handed out as CPU
torch tensors in the reference's 32-bit dtypes (``tensor/_common.py``'s
rule: int64 as int32, float64 as float32, complex128 as complex64, as
``paddle_tpu/io/reader.py:53-57`` makes its tensors), whether the
samples were numpy arrays, Python numbers or torch tensors;
``jit.TrainStep`` moves them to the model's device. The
reference's worker threads and processes (``num_workers > 0``) and
``prefetch.py`` are not ported (ROADMAP queue A.7): asking for workers
raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tensor._common import _NARROW
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


def default_collate_fn(batch):
    """Stack a list of samples into batched arrays (the reference's
    rules; torch tensors are stacked as tensors)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch, 0)
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch, axis=0)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn(list(f)) for f in zip(*batch))
    try:
        return np.asarray(batch)
    except Exception:  # noqa: BLE001 — ragged: hand the list on
        return list(batch)


def _to_tensor(item, to_tensor=True):
    if not to_tensor:
        return item
    if isinstance(item, np.ndarray):
        item = torch.from_numpy(np.ascontiguousarray(item))
    if isinstance(item, torch.Tensor):
        return item.to(_NARROW.get(item.dtype, item.dtype))
    if isinstance(item, dict):
        return {k: _to_tensor(v) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return tuple(_to_tensor(v) for v in item)
    return item


class _MapIter:
    def __init__(self, loader):
        self._loader = loader
        self._index_iter = iter(loader.batch_sampler)

    def __iter__(self):
        return self

    def __next__(self):
        indices = next(self._index_iter)
        out = self._loader.collate_fn([self._loader.dataset[i]
                                       for i in indices])
        return _to_tensor(out, self._loader.return_list is not False)


class _IterableIter:
    def __init__(self, loader):
        self._loader = loader
        self._it = iter(loader.dataset)

    def __iter__(self):
        return self

    def __next__(self):
        loader = self._loader
        if loader.batch_size is None:
            return _to_tensor(loader.collate_fn([next(self._it)]),
                              loader.return_list is not False)
        batch = []
        for _ in range(loader.batch_size):
            try:
                batch.append(next(self._it))
            except StopIteration:
                break
        if not batch or (loader.drop_last
                         and len(batch) < loader.batch_size):
            raise StopIteration
        return _to_tensor(loader.collate_fn(batch),
                          loader.return_list is not False)


class DataLoader:
    """``paddle.io.DataLoader`` over a map-style or iterable dataset, with
    the reference's arguments; ``num_workers`` must be 0."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, worker_mode=None):
        if int(num_workers) != 0:
            raise NotImplementedError(
                "DataLoader: num_workers > 0 (worker threads or processes) "
                "is not ported (ROADMAP queue A.7); use num_workers=0")
        if batch_size is not None and int(batch_size) <= 0:
            raise ValueError(
                f"paddle.io.DataLoader: batch_size must be a positive int "
                f"or None (got {batch_size})")
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = 0
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size",
                                      batch_size)
        else:
            if batch_size is None:
                raise ValueError("batch_size=None requires a batch_sampler")
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __iter__(self):
        if self._iterable_mode:
            return _IterableIter(self)
        return _MapIter(self)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("DataLoader over IterableDataset has no len()")
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()
