"""In-memory datasets and the normalizers fit on the train split.

Counterpart of resolution_pde_tpu/data/dataset.py (reference
ks_naive_markov.py:374-435: x stats from train x, y stats from train y;
burger_resize_markov.py:215-243: the minmax branch). Arrays are numpy on
the host; the normalizers are ``ops.normalizers``' classes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from resolution_pde_tpu_torch.ops.normalizers import (
    SimpleNormalizer,
    UnitGaussianNormalizer,
)


def _encode(normalizer, a: np.ndarray) -> np.ndarray:
    out = normalizer.encode(torch.from_numpy(np.asarray(a)))
    return np.asarray(out, dtype=np.float32)


@dataclass
class ArrayDataset:
    """Markov-pair dataset: x (N, C, *spatial), y (N, C, *spatial)."""

    x: np.ndarray
    y: np.ndarray

    def __post_init__(self):
        if len(self.x) != len(self.y):
            raise ValueError(f"invalid input/output pairs: {len(self.x)} "
                             f"inputs, {len(self.y)} outputs")

    def __len__(self):
        return len(self.x)

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]

    @property
    def resolution(self) -> int:
        return self.x.shape[-1]

    def encoded(self, x_normalizer, y_normalizer) -> "ArrayDataset":
        """A normalized copy (the reference's NormalizedDataset encodes per
        item; encoding once is the same and batch-friendly)."""
        return ArrayDataset(_encode(x_normalizer, self.x),
                            _encode(y_normalizer, self.y))


@dataclass
class TrajectoryDataset:
    """Full trajectories for rollout evaluation: u (N, T, *spatial)."""

    u: np.ndarray

    def __len__(self):
        return len(self.u)

    def __getitem__(self, idx):
        return self.u[idx]

    @property
    def resolution(self) -> int:
        return self.u.shape[-1]


class MultiResTrajectoryDataset:
    """Rollout trajectories by stored resolution, {resolution:
    TrajectoryDataset}, from the per-resolution files of a true-multires
    dataset. ``u`` is the base (highest) resolution's bucket."""

    def __init__(self, buckets: Dict[int, TrajectoryDataset],
                 base_res: int | None = None):
        if not buckets:
            raise ValueError("empty trajectory buckets")
        self.buckets = dict(buckets)
        self.base_res = (base_res if base_res in self.buckets
                         else max(self.buckets))

    @property
    def u(self) -> np.ndarray:
        return self.buckets[self.base_res].u

    def at(self, resolution: int):
        """The TrajectoryDataset stored at ``resolution``, or None."""
        return self.buckets.get(resolution)

    def resolutions(self):
        return sorted(self.buckets)

    def __len__(self):
        return sum(len(d) for d in self.buckets.values())


class MultiResDataset:
    """Samples at several resolutions as {resolution: ArrayDataset}
    buckets, so every batch has one shape (train/mres_training.py:75-131)."""

    def __init__(self, buckets: Dict[int, ArrayDataset]):
        self.buckets = dict(sorted(buckets.items()))

    def __len__(self):
        return sum(len(d) for d in self.buckets.values())

    @property
    def resolutions(self):
        return list(self.buckets)

    def encoded(self, x_normalizer, y_normalizer) -> "MultiResDataset":
        return MultiResDataset({r: d.encoded(x_normalizer, y_normalizer)
                                for r, d in self.buckets.items()})


def fit_normalizers(train_x: np.ndarray, train_y: np.ndarray,
                    normalization_type: str = "simple") -> dict:
    """Normalizers fit on the train split: 'simple' (global scalar stats)
    and 'unit_gaussian' (per-location) give {x_normalizer, y_normalizer};
    'minmax' gives {min_data, max_data, min_model, max_model}."""
    if normalization_type == "simple":
        return {"x_normalizer": SimpleNormalizer.fit(train_x),
                "y_normalizer": SimpleNormalizer.fit(train_y)}
    if normalization_type == "unit_gaussian":
        return {"x_normalizer": UnitGaussianNormalizer.fit(train_x),
                "y_normalizer": UnitGaussianNormalizer.fit(train_y)}
    if normalization_type == "minmax":
        return {"min_data": float(train_x.min()),
                "max_data": float(train_x.max()),
                "min_model": float(train_y.min()),
                "max_model": float(train_y.max())}
    raise ValueError(f"unknown normalization_type {normalization_type!r}")


class MinMaxNormalizer:
    """encode: (x - min) / (max - min); decode is train/training.py:90-91.
    The bounds are Python floats, so ``to`` returns the normalizer as is."""

    def __init__(self, min_val: float, max_val: float):
        self.min = min_val
        self.max = max_val

    def to(self, device) -> "MinMaxNormalizer":
        return self

    def encode(self, x):
        return (x - self.min) / (self.max - self.min)

    def decode(self, x):
        return x * (self.max - self.min) + self.min
