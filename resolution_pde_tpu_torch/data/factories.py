"""Dataset factories of the Navier-Stokes path and the S4 family's KS
windows.

Counterpart of resolution_pde_tpu/data/factories.py's
``ns_markov_dataset`` (:458), ``ns_true_multires_markov_dataset`` (:485)
and ``ks_window_dataset`` (:711, with ``_ks_load``, :142), with the
helpers they call. Each returns the positional tuple the drivers consume:

  'simple' / 'unit_gaussian':
     (train, val, test, rollout, x_normalizer, y_normalizer)
  'minmax':
     (train, val, test, rollout, min_data, max_data, min_model, max_model)

train/val/test are ArrayDatasets (MultiResDatasets for true-multires),
already encoded with the normalizers fit on train; rollout holds the raw
test trajectories, which the rollout encodes itself.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from resolution_pde_tpu_torch.data import io as data_io
from resolution_pde_tpu_torch.data.dataset import (
    ArrayDataset,
    MinMaxNormalizer,
    MultiResDataset,
    MultiResTrajectoryDataset,
    TrajectoryDataset,
    fit_normalizers,
)
from resolution_pde_tpu_torch.data.transforms import (
    lowpass_2d_channels_last,
    markov_pairs_2d,
    reduce_trajectories,
    resize_trajectories,
    sliding_windows,
    split_ratio_indices,
)

SPLITS = ("train", "val", "test")


def _randsplit_indices(n: int, seed: int = 42) -> np.ndarray:
    """The permutation of the reference's 0.8/0.1/0.1 random_split:
    torch.randperm from a generator seeded with ``seed``
    (burger_naive_markov.py:249-253)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=g).numpy()


def _split_pairs(x, y, split=(0.8, 0.1, 0.1), seed: int = 42):
    n = len(x)
    perm = _randsplit_indices(n, seed)
    train_end = int(split[0] * n)
    val_end = train_end + int(split[1] * n)
    tr, va, te = perm[:train_end], perm[train_end:val_end], perm[val_end:]
    return (ArrayDataset(x[tr], y[tr]), ArrayDataset(x[va], y[va]),
            ArrayDataset(x[te], y[te]))


def _memo_loader(fn):
    """Cache a per-resolution loader: the true-multires factory reads the
    base file for its buckets, the add_res block and the rollout block."""
    cache = {}

    def wrapped(res):
        if res not in cache:
            cache[res] = fn(res)
        return cache[res]

    return wrapped


def _flat(ds: MultiResDataset, attr: str) -> np.ndarray:
    return np.concatenate([getattr(d, attr).reshape(-1)
                           for d in ds.buckets.values()])


def _package(train, val, test, rollout, data_normalizer: bool,
             normalization_type: str):
    """Fit the normalizers on train, encode the splits, build the tuple."""
    if not data_normalizer:
        return train, val, test, rollout, None, None
    multires = isinstance(train, MultiResDataset)
    if normalization_type in ("simple", "unit_gaussian"):
        if multires:
            if normalization_type == "unit_gaussian":
                warnings.warn(
                    "unit_gaussian per-location statistics cannot span "
                    "mixed-resolution buckets; falling back to global "
                    "scalar (simple) normalization", stacklevel=3)
            stats = fit_normalizers(_flat(train, "x"), _flat(train, "y"),
                                    "simple")
        else:
            stats = fit_normalizers(train.x, train.y, normalization_type)
        xn, yn = stats["x_normalizer"], stats["y_normalizer"]
        return (train.encoded(xn, yn), val.encoded(xn, yn),
                test.encoded(xn, yn), rollout, xn, yn)
    if normalization_type == "minmax":
        if multires:
            stats = fit_normalizers(_flat(train, "x"), _flat(train, "y"),
                                    "minmax")
        else:
            stats = fit_normalizers(train.x, train.y, "minmax")
        xn = MinMaxNormalizer(stats["min_data"], stats["max_data"])
        yn = MinMaxNormalizer(stats["min_model"], stats["max_model"])
        return (train.encoded(xn, yn), val.encoded(xn, yn),
                test.encoded(xn, yn), rollout,
                stats["min_data"], stats["max_data"],
                stats["min_model"], stats["max_model"])
    raise ValueError(f"unknown normalization_type {normalization_type!r}")


def _rollout_buckets_per_res(load_res, data_mres_size, split_ratio,
                             random_seed, base_res, to_traj):
    """Rollout trajectories by stored resolution, from the test split of
    each per-resolution file (the same subsample seed and indices as the
    Markov test split; the reference's
    extract_ks_test_trajectories_for_rollout, ks_naive_true_multires.py:
    32-172), plus the base resolution. to_traj(test_u) -> (key,
    trajectories)."""
    rollout_buckets = {}
    for resolution, target in sorted((data_mres_size or {}).items()):
        if target == 0:
            continue
        u = load_res(resolution)
        if u is None:
            continue
        _, va_end = split_ratio_indices(u.shape[0], split_ratio)
        test_u = u[va_end:]
        # a target at or above the test split keeps every test trajectory
        if 0 < target < test_u.shape[0]:
            k = int(target * split_ratio[2])
            if k <= 0:
                continue
            rs = np.random.RandomState(random_seed + resolution + 2)
            test_u = test_u[rs.choice(test_u.shape[0],
                                      min(k, test_u.shape[0]),
                                      replace=False)]
        key, traj = to_traj(test_u)
        rollout_buckets[key] = TrajectoryDataset(traj)
    if base_res is not None:
        u_base = load_res(base_res)
        if u_base is not None:
            _, va_end = split_ratio_indices(u_base.shape[0], split_ratio)
            key, traj = to_traj(u_base[va_end:])
            if key not in rollout_buckets:
                rollout_buckets[key] = TrajectoryDataset(traj)
    return rollout_buckets


def ns_markov_dataset(filename, saved_folder, use_low_pass_filter=False,
                      lowpass_cutoff_ratio=1.0, data_normalizer=True,
                      normalization_type="unit_gaussian",
                      reduced_batch=1, reduced_resolution=1,
                      reduced_resolution_t=1, num_samples_max=-1,
                      s=None):
    """NS vorticity, naive or low-passed (ns_naive_markov.py:325); ``s``
    FFT-resizes the grid."""
    u = data_io.read_ns(os.path.join(saved_folder, filename))[..., None]
    u = reduce_trajectories(
        u, reduced_batch, reduced_resolution, reduced_resolution_t,
        use_low_pass_filter, lowpass_cutoff_ratio, num_samples_max,
        spatial_ndim=2)
    if s is not None:
        u_cl = resize_trajectories(np.moveaxis(u, -1, 2), s, spatial_ndim=2)
        u = np.moveaxis(u_cl, 2, -1)
    x, y = markov_pairs_2d(u)
    train, val, test = _split_pairs(x, y, seed=42)
    _, va_end = split_ratio_indices(u.shape[0])
    rollout = TrajectoryDataset(np.ascontiguousarray(u[va_end:, :, :, :, 0]))
    return _package(train, val, test, rollout, data_normalizer,
                    normalization_type)


def _subsample(part, target, n_total, k_ratio, seed):
    """The per-split subsample of the true-multires factories: ``k`` of
    the split's trajectories without replacement, or all of them."""
    if not 0 < target < n_total:
        return part
    k = int(target * k_ratio)
    if k <= 0:
        return None
    rs = np.random.RandomState(seed)
    return part[rs.choice(part.shape[0], min(k, part.shape[0]),
                          replace=False)]


def ns_true_multires_markov_dataset(
        saved_folder, file_map: Optional[Dict[int, str]] = None,
        viscosity="1e-3", file_extension=".h5",
        reduced_batch=1, reduced_resolution_t=1,
        data_mres_size: Optional[Dict[int, int]] = None,
        add_res=None, add_res_samples=None, downsample_from_res=None,
        use_low_pass_filter=False, lowpass_cutoff_ratio=1.0,
        split_ratio=None, random_seed=42, data_normalizer=True,
        normalization_type="simple", num_samples_max=-1,
        eval_dataset_target=None, eval_filename=None,
        eval_saved_folder=None):
    """True multi-resolution NS (ns_naive_true_multires.py:396): a file per
    resolution, from ``file_map`` {res: filename} or the reference's names
    ns_{res}_{viscosity}{file_extension}. ``num_samples_max`` is accepted
    and ignored, as the reference does; the eval_* keys are the eval
    driver's (cli/common.py)."""
    if split_ratio is None:
        split_ratio = [0.8, 0.1, 0.1]
    if file_map is None:
        resolutions = set(data_mres_size or {})
        if downsample_from_res:
            resolutions.add(downsample_from_res)
        file_map = {r: f"ns_{r}_{viscosity}{file_extension}"
                    for r in resolutions}
    data_mres_size = data_mres_size or {r: -1 for r in file_map}
    buckets = {name: {} for name in SPLITS}

    def load_res(resolution):
        if resolution not in file_map:
            return None
        path = os.path.join(saved_folder, file_map[resolution])
        if not os.path.exists(path):
            return None
        u = data_io.read_ns(path)[..., None]
        return u[::reduced_batch, ::reduced_resolution_t]

    load_res = _memo_loader(load_res)
    for resolution, target in sorted(data_mres_size.items()):
        if target == 0:
            continue
        u = load_res(resolution)
        if u is None:
            continue
        tr_end, va_end = split_ratio_indices(u.shape[0], split_ratio)
        parts = (u[:tr_end], u[tr_end:va_end], u[va_end:])
        for si, name in enumerate(SPLITS):
            part = _subsample(parts[si], target, u.shape[0], split_ratio[si],
                              random_seed + resolution + si)
            if part is None:
                continue
            x, y = markov_pairs_2d(part.astype(np.float32))
            buckets[name][x.shape[-1]] = ArrayDataset(x, y)

    # extra resolutions, naive strides or low-passed, from the base file
    base_res = downsample_from_res or (max(file_map) if file_map else None)
    if add_res and add_res_samples and base_res:
        u_base = load_res(base_res)
        if u_base is not None:
            src_res = u_base.shape[2]
            tr_end, va_end = split_ratio_indices(u_base.shape[0], split_ratio)
            parts = (u_base[:tr_end], u_base[tr_end:va_end], u_base[va_end:])
            for target_res in add_res:
                if target_res >= src_res:
                    continue
                n_target = add_res_samples.get(target_res, 100)
                for si, name in enumerate(SPLITS):
                    k = int(n_target * split_ratio[si])
                    if k <= 0:
                        continue
                    rs = np.random.RandomState(
                        random_seed + target_res + si + 10000)
                    sampled = parts[si][rs.choice(parts[si].shape[0], k,
                                                  replace=True)]
                    if use_low_pass_filter:
                        # filtered only: the samples stay at src_res
                        down = lowpass_2d_channels_last(
                            sampled,
                            (target_res / src_res) * lowpass_cutoff_ratio)
                    else:
                        f = src_res // target_res
                        down = sampled[:, :, ::f, ::f]
                    x, y = markov_pairs_2d(down.astype(np.float32))
                    key = x.shape[-1]
                    if key in buckets[name]:
                        old = buckets[name][key]
                        x = np.concatenate([old.x, x])
                        y = np.concatenate([old.y, y])
                    buckets[name][key] = ArrayDataset(x, y)

    rollout_buckets = _rollout_buckets_per_res(
        load_res, data_mres_size, split_ratio, random_seed, base_res,
        to_traj=lambda test_u: (
            test_u.shape[2],
            np.ascontiguousarray(test_u[:, :, :, :, 0], dtype=np.float32)))
    rollout = (MultiResTrajectoryDataset(rollout_buckets)
               if rollout_buckets else None)
    return _package(MultiResDataset(buckets["train"]),
                    MultiResDataset(buckets["val"]),
                    MultiResDataset(buckets["test"]), rollout,
                    data_normalizer, normalization_type)


# ---------------------------------------------------------------------------
# KS (separate train/valid/test files)
# ---------------------------------------------------------------------------

def _ks_load(filename, saved_folder, *, s=None, resize_method="resize",
             **red_kw) -> np.ndarray:
    """A KS file's trajectories (b, t, s), reduced (``red_kw``: the
    ``reduce_trajectories`` strides and filter) and, with ``s``, resized."""
    path = os.path.join(os.path.abspath(saved_folder), filename)
    u = data_io.read_ks_h5(path)["u"]
    u = reduce_trajectories(u, spatial_ndim=1, **red_kw)
    if s is not None:
        u = resize_trajectories(u, s, spatial_ndim=1, method=resize_method)
    return u


def ks_window_splits(train_u, val_u, test_u, window_size=10,
                     data_normalizer=True):
    """``ks_window_dataset`` on trajectories already read: (b, t, s) arrays
    of the train, valid and test files. Each split's sliding windows
    (x (N, window_size, s), y (N, s), no channel axis), SimpleNormalizers
    fit on train, and the raw test trajectories in the rollout slot."""
    splits = [ArrayDataset(*sliding_windows(u, window_size))
              for u in (train_u, val_u, test_u)]
    return _package(*splits, TrajectoryDataset(test_u), data_normalizer,
                    "simple")


def ks_window_dataset(filename, saved_folder, window_size=10,
                      data_normalizer=True, reduced_batch=1,
                      reduced_resolution=1, reduced_resolution_t=1,
                      num_samples_max=-1, val_filename="KS_valid.h5",
                      test_filename="KS_test.h5"):
    """Sliding-window dataset from KS-format files (the S4 path on KS data;
    the window template of dataloaders/burger_s4.py applied to the KS
    reader)."""
    red = dict(reduced_batch=reduced_batch,
               reduced_resolution=reduced_resolution,
               reduced_resolution_t=reduced_resolution_t,
               num_samples_max=num_samples_max)
    us = [_ks_load(fn, saved_folder, **red)
          for fn in (filename, val_filename, test_filename)]
    return ks_window_splits(*us, window_size=window_size,
                            data_normalizer=data_normalizer)
