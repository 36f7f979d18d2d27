"""Data loading, single process.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py``
(``DeepSpeedDataLoader`` :72, ``RepeatingLoader`` :53) on one device: the
same numpy-seeded order, so both packages yield the same batches from the
same seed. Batches are dicts of numpy arrays stacked from the samples; the
engine moves them to its device.
"""
from __future__ import annotations

from typing import Any, Iterator

import numpy as np


class RepeatingLoader:
    """Wraps an iterable and restarts it at ``StopIteration``."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


def _stack(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([s[i] for s in samples])
                           for i in range(len(first)))
    return np.stack(samples)


class DeepSpeedDataLoader:
    """Batches of ``batch_size`` samples from an indexable dataset
    (shuffled per epoch by a ``numpy.random.default_rng(seed)``, the last
    partial batch dropped), or the items of an iterable one."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, collate_fn=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn
        self._rng = np.random.default_rng(seed)
        self._epoch = 0
        self._active_iter = None
        if hasattr(dataset, "__len__") and hasattr(dataset, "__getitem__"):
            self.len = len(dataset) // batch_size
            self._mode = "indexable"
        else:
            self.len = None
            self._mode = "iterable"
            self._iter = iter(dataset)

    def __len__(self):
        if self.len is None:
            raise TypeError("iterable dataset has no length")
        return self.len

    def __iter__(self) -> Iterator[Any]:
        if self._mode == "iterable":
            return iter(self.dataset)
        return self._index_iter()

    def _index_iter(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        for start in range(0, n - self.batch_size + 1, self.batch_size):
            samples = [self.dataset[int(i)]
                       for i in order[start:start + self.batch_size]]
            yield (self.collate_fn(samples) if self.collate_fn is not None
                   else _stack(samples))

    def __next__(self):
        if self._mode == "iterable":
            return next(self._iter)
        if self._active_iter is None:
            self._active_iter = self._index_iter()
        try:
            return next(self._active_iter)
        except StopIteration:
            self._active_iter = self._index_iter()
            return next(self._active_iter)
