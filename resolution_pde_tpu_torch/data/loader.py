"""Batched loaders.

Counterpart of resolution_pde_tpu/data/loader.py (reference
ResolutionGroupedDataLoader, train/mres_training.py:75-131). The batch
order is a pure function of (seed, epoch): ``np.random.default_rng((seed,
epoch))``, so the port draws the JAX package's batch order, and a resumed
run fast-forwards with ``set_epoch``. Batches are gathered with numpy
fancy indexing on the host; the Trainer copies them to the card through
pinned memory. The JAX package's C++ gather pipeline (data/native.py) is
not ported.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from resolution_pde_tpu_torch.data.dataset import ArrayDataset, MultiResDataset


def _n_batches(n: int, batch_size: int, drop_last: bool) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


class Loader:
    """Shuffling mini-batch iterator over an ArrayDataset. Re-iterable:
    each ``__iter__`` draws the permutation of the next epoch."""

    def __init__(self, dataset: ArrayDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Make the next ``__iter__`` draw epoch ``epoch``'s permutation
        (mid-training resume, cli/common.maybe_resume)."""
        self._epoch = int(epoch)

    def __len__(self):
        return _n_batches(len(self.dataset), self.batch_size, self.drop_last)

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        idx = rng.permutation(n) if self.shuffle else np.arange(n)
        stop = n - n % self.batch_size if self.drop_last else n
        x, y = self.dataset.x, self.dataset.y
        for i in range(0, stop, self.batch_size):
            sel = idx[i: i + self.batch_size]
            yield np.ascontiguousarray(x[sel]), np.ascontiguousarray(y[sel])


class ResolutionBucketedLoader:
    """Batches of one resolution each from a MultiResDataset, the batch
    order shuffled across buckets each epoch (mres_training.py:108-128)."""

    def __init__(self, dataset: MultiResDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """See Loader.set_epoch."""
        self._epoch = int(epoch)

    def __len__(self):
        return sum(_n_batches(len(d), self.batch_size, self.drop_last)
                   for d in self.dataset.buckets.values())

    def __iter__(self) -> Iterator:
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        plans = []  # (resolution, sample indices) per batch
        for res, d in self.dataset.buckets.items():
            n = len(d)
            idx = rng.permutation(n) if self.shuffle else np.arange(n)
            stop = n - n % self.batch_size if self.drop_last else n
            for i in range(0, stop, self.batch_size):
                plans.append((res, idx[i: i + self.batch_size]))
        order = (rng.permutation(len(plans)) if self.shuffle
                 else np.arange(len(plans)))
        for j in order:
            res, sel = plans[j]
            d = self.dataset.buckets[res]
            yield np.ascontiguousarray(d.x[sel]), np.ascontiguousarray(d.y[sel])


def create_grouped_dataloaders(train_ds, val_ds, test_ds, batch_size: int,
                               seed: int = 0):
    """Reference factory (train/mres_training.py:146): the grouped train
    loader shuffled, val and test in order."""
    return (
        ResolutionBucketedLoader(train_ds, batch_size, shuffle=True,
                                 seed=seed),
        ResolutionBucketedLoader(val_ds, batch_size, shuffle=False),
        ResolutionBucketedLoader(test_ds, batch_size, shuffle=False),
    )
