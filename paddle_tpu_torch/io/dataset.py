"""Dataset types: a copy of ``paddle_tpu/io/dataset.py``
(``random_split`` draws its permutation from ``np.random``, or from the
numpy ``generator`` given, as there)."""
from __future__ import annotations

import bisect

import numpy as np


class Dataset:
    """Map-style dataset: `__getitem__` + `__len__`."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    """Stream-style dataset: `__iter__` only."""

    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Wraps same-length tensors; item i is the tuple of i-th slices."""

    def __init__(self, tensors):
        lens = {len(t) for t in tensors}
        if len(lens) != 1:
            raise ValueError("all tensors must have the same first dim")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    """Zips multiple map-style datasets; item i concatenates their fields."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("datasets must not be empty")
        n = len(self.datasets[0])
        for d in self.datasets:
            if len(d) != n:
                raise ValueError("datasets must have equal lengths")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            item = d[idx]
            sample.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(sample)


class ChainDataset(IterableDataset):
    """Concatenates iterable datasets as one stream."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    """Concatenates map-style datasets (reference `ConcatDataset`)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Split into non-overlapping subsets (reference `dataset.py` random_split).
    Fractional lengths summing to 1 are also accepted."""
    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        counts = [int(np.floor(n * frac)) for frac in lengths]
        rem = n - sum(counts)
        for i in range(rem):
            counts[i % len(counts)] += 1
        lengths = counts
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    rng = generator or np.random
    perm = rng.permutation(sum(lengths)).tolist()
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l]))
        offset += l
    return out
