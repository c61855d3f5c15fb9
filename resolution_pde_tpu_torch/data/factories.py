"""Dataset factories of the Navier-Stokes, KS, Burgers, Darcy,
active-matter and point-cloud paths.

Counterpart of resolution_pde_tpu/data/factories.py's
``ns_markov_dataset`` (:458), ``ns_true_multires_markov_dataset`` (:485),
``ks_window_dataset`` (:711, with ``_ks_load``, :142), the KS Markov
factories: ``ks_markov_dataset`` (:152), ``ks_true_multires_markov_dataset``
(:192, with ``_generic_true_multires_1d``, :355),
``ks_multires_markov_dataset`` (:919), ``ks_resize_multires_markov_dataset``
(:1059) and ``ks_pino_markov_dataset`` (:799); the Burgers factories:
``burger_markov_dataset`` (:244), ``burger_true_multires_markov_dataset``
(:274), ``burger_multires_markov_dataset`` (:976),
``burger_resize_multires_markov_dataset`` (:1067),
``burger_resize_true_multires_markov_dataset`` (:1097),
``burger_window_dataset`` (:666) and ``load_burger_data_from_mat`` (:736);
the NS sliding windows, ``ns_window_dataset`` (:684);
the Darcy ones: ``darcy_dataset`` (:617), ``load_darcy_data_from_mat``
(:758) and ``load_darcy_data`` (:774); and the active-matter ones:
``active_matter_markov_dataset`` (:641), ``active_matter_all_markov_dataset``
(:832) and ``multi_file_active_matter_markov_dataset`` (:1073); and the
GNOT point-cloud one, ``point_cloud_markov_dataset`` (:1105); with the
helpers they call.
Each returns the positional tuple the command lines consume:

  'simple' / 'unit_gaussian':
     (train, val, test, rollout, x_normalizer, y_normalizer)
  'minmax':
     (train, val, test, rollout, min_data, max_data, min_model, max_model)

(ks_pino_markov_dataset: the minmax 7-tuple without the rollout slot;
load_darcy_data: the legacy 4-tuple (train, test, x_normalizer,
y_normalizer).) train/val/test are ArrayDatasets (MultiResDatasets for
true-multires), already encoded with the normalizers fit on train;
rollout holds the raw test trajectories, which the rollout encodes
itself (None for the steady-state and single-step datasets).
``ks_window_splits``, ``ks_markov_splits`` and ``ks_true_multires_splits``
take trajectories already read, as arrays: the file-reading factories
call them."""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Sequence

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
    lowpass_1d,
    lowpass_2d_channels_last,
    markov_pairs_1d,
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


def _merge_bucket(buckets, key, x, y):
    if key in buckets:
        old = buckets[key]
        buckets[key] = ArrayDataset(np.concatenate([old.x, x]),
                                    np.concatenate([old.y, y]))
    else:
        buckets[key] = ArrayDataset(x, y)


def _true_multires(load_res, data_mres_size, add_res, add_res_samples,
                   base_res, split_ratio, random_seed, pair, reduce, to_traj,
                   data_normalizer, normalization_type):
    """The true multi-resolution factories' pipeline, whose tuple it
    returns. Per resolution of ``data_mres_size`` with a nonzero target:
    a contiguous ``split_ratio`` split of ``load_res(resolution)``, each
    split subsampled (``_subsample``, RandomState(random_seed + resolution
    + split index)), its Markov pairs (``pair``) a bucket. Then ``add_res``
    from the base resolution: per split int(add_res_samples[r] x ratio)
    trajectories drawn with replacement by RandomState(random_seed + r +
    split index + 10000), ``reduce(sampled, r, src_res)`` (a stride, or a
    low-pass that keeps src_res), merged into the bucket of their width;
    src_res is the base's axis 2 and no r at or above it is drawn. The
    rollout holds each resolution's test trajectories (``to_traj``),
    subsampled as the Markov test split, and the base's."""
    buckets = {name: {} for name in SPLITS}
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
            x, y = pair(part.astype(np.float32))
            buckets[name][x.shape[-1]] = ArrayDataset(x, y)
    u_base = (load_res(base_res)
              if add_res and add_res_samples and base_res else None)
    if u_base is not None:
        src_res = u_base.shape[2]
        tr_end, va_end = split_ratio_indices(u_base.shape[0], split_ratio)
        parts = (u_base[:tr_end], u_base[tr_end:va_end], u_base[va_end:])
        for target_res in (r for r in add_res if r < src_res):
            n_target = (add_res_samples.get(target_res, 100)
                        if isinstance(add_res_samples, dict)
                        else int(add_res_samples))
            for si, name in enumerate(SPLITS):
                k = int(n_target * split_ratio[si])
                if k <= 0:
                    continue
                rs = np.random.RandomState(
                    random_seed + target_res + si + 10000)
                sampled = parts[si][rs.choice(parts[si].shape[0], k,
                                              replace=True)]
                x, y = pair(reduce(sampled, target_res, src_res)
                            .astype(np.float32))
                _merge_bucket(buckets[name], x.shape[-1], x, y)
    rollout_buckets = _rollout_buckets_per_res(
        load_res, data_mres_size, split_ratio, random_seed, base_res,
        to_traj)
    rollout = (MultiResTrajectoryDataset(rollout_buckets)
               if rollout_buckets else None)
    return _package(*(MultiResDataset(buckets[name]) for name in SPLITS),
                    rollout, data_normalizer, normalization_type)


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

    def load_res(resolution):
        if resolution not in file_map:
            return None
        path = os.path.join(saved_folder, file_map[resolution])
        if not os.path.exists(path):
            return None
        u = data_io.read_ns(path)[..., None]
        return u[::reduced_batch, ::reduced_resolution_t]

    def reduce(sampled, target_res, src_res):
        if use_low_pass_filter:
            # filtered only: the samples stay at src_res
            return lowpass_2d_channels_last(
                sampled, (target_res / src_res) * lowpass_cutoff_ratio)
        f = src_res // target_res
        return sampled[:, :, ::f, ::f]

    load_res = _memo_loader(load_res)
    base_res = downsample_from_res or (max(file_map) if file_map else None)
    return _true_multires(
        load_res, data_mres_size, add_res, add_res_samples, base_res,
        split_ratio, random_seed, markov_pairs_2d, reduce,
        lambda test_u: (test_u.shape[2], np.ascontiguousarray(
            test_u[:, :, :, :, 0], dtype=np.float32)),
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


def ks_markov_splits(train_u, val_u, test_u, data_normalizer=True):
    """``ks_markov_dataset`` on trajectories already read and reduced:
    (b, t, s) arrays of the train, valid and test files. Each split's
    Markov pairs (x = u[:, :-1], y = u[:, 1:], (N, 1, s)),
    SimpleNormalizers fit on train, the raw test trajectories in the
    rollout slot."""
    splits = [ArrayDataset(*markov_pairs_1d(u))
              for u in (train_u, val_u, test_u)]
    return _package(*splits, TrajectoryDataset(test_u), data_normalizer,
                    "simple")


def ks_markov_dataset(filename, saved_folder, data_normalizer=True,
                      use_low_pass_filter=False, lowpass_cutoff_ratio=1.0,
                      val_filename="KS_valid.h5", test_filename="KS_test.h5",
                      reduced_batch=1, reduced_resolution=1,
                      reduced_resolution_t=1, num_samples_max=-1,
                      s=None, normalization_type="simple",
                      viscosity=None, L=None, lmax=None, et=None, nte=None,
                      nt=None):
    """KS, naive or low-passed (ks_naive_markov.py:309); ``s`` FFT-resizes
    (ks_resize_markov.py:206). Always SimpleNormalizers, whatever
    ``normalization_type`` says (main_1d reads it to decode); the
    generator's provenance keys (viscosity ... nt) are accepted and
    ignored, as the reference does."""
    red = dict(reduced_batch=reduced_batch,
               reduced_resolution=reduced_resolution,
               reduced_resolution_t=reduced_resolution_t,
               use_low_pass_filter=use_low_pass_filter,
               lowpass_cutoff_ratio=lowpass_cutoff_ratio,
               num_samples_max=num_samples_max)
    us = [_ks_load(fn, saved_folder, s=s, **red)
          for fn in (filename, val_filename, test_filename)]
    return ks_markov_splits(*us, data_normalizer=data_normalizer)


def _ks_res_dir(saved_folder, resolution, viscosity, L, lmax, et, nte, nt):
    dir_name = f"visc_{viscosity}_L{L}_lmax{lmax}_et{et}_nte{nte}_nt{nt}"
    return os.path.join(saved_folder, f"res_{resolution}", dir_name)


def _base_resolution(data_mres_size, downsample_from_res):
    return downsample_from_res or (max(data_mres_size)
                                   if data_mres_size else None)


def _reduce_1d(method, use_low_pass_filter, lowpass_cutoff_ratio):
    """reduce(sampled, target_res, src_res) of the 1D true-multires
    factories' extra resolutions: an FFT downsample ('resize'), else a
    low-pass that keeps src_res, else a stride that keeps ceil(src /
    factor) points when target_res does not divide src_res, as the
    reference does."""
    def reduce(sampled, target_res, src_res):
        if method == "resize":
            return resize_trajectories(sampled, target_res, spatial_ndim=1,
                                       method="downsample")
        if use_low_pass_filter:
            return lowpass_1d(sampled,
                              (target_res / src_res) * lowpass_cutoff_ratio)
        return sampled[:, :, ::src_res // target_res]

    return reduce


def ks_true_multires_splits(
        u_by_res: Dict[int, np.ndarray],
        data_mres_size: Optional[Dict[int, int]] = None,
        add_res: Optional[Sequence[int]] = None,
        add_res_samples=None, downsample_from_res: Optional[int] = None,
        use_low_pass_filter=False, lowpass_cutoff_ratio=1.0,
        split_ratio=None, random_seed=42, data_normalizer=True,
        normalization_type="simple", pair=markov_pairs_1d,
        add_res_method="naive"):
    """The true multi-resolution pipeline on trajectories already read:
    ``u_by_res`` {resolution: (n, t, s) array} (a missing resolution is
    skipped). Per resolution of ``data_mres_size`` with a nonzero target:
    a contiguous ``split_ratio`` split, each split subsampled to
    int(target x ratio) trajectories by RandomState(random_seed +
    resolution + split index) when the target is below the count, Markov
    pairs (``pair``; the Burgers factories skip the first snapshot) in a
    bucket per resolution. ``add_res`` adds resolutions drawn from the
    base one (``downsample_from_res``, else the largest): per split
    int(add_res_samples[r] x ratio) trajectories with replacement by
    RandomState(random_seed + r + split index + 10000), reduced to r
    (``_reduce_1d``: ``add_res_method`` 'resize', or a low-pass left at
    the base resolution, or a stride). The rollout holds each
    resolution's test trajectories (subsampled as the Markov test split)
    and the base's."""
    if split_ratio is None:
        split_ratio = [0.8, 0.1, 0.1]
    data_mres_size = data_mres_size or {}
    return _true_multires(
        u_by_res.get, data_mres_size, add_res, add_res_samples,
        _base_resolution(data_mres_size, downsample_from_res), split_ratio,
        random_seed, pair,
        _reduce_1d(add_res_method, use_low_pass_filter,
                   lowpass_cutoff_ratio),
        lambda test_u: (test_u.shape[-1], np.ascontiguousarray(
            test_u, dtype=np.float32)),
        data_normalizer, normalization_type)


def _needed_resolutions(data_mres_size, downsample_from_res) -> list:
    """The resolutions a true-multires factory reads: those of
    ``data_mres_size`` with a nonzero target, and the base one."""
    needed = {r for r, target in data_mres_size.items() if target != 0}
    base_res = _base_resolution(data_mres_size, downsample_from_res)
    if base_res:
        needed.add(base_res)
    return sorted(needed)


def ks_true_multires_markov_dataset(
        saved_folder, viscosity=0.05, L=64.0, lmax=8, et=5.0, nte=51, nt=51,
        train_s=2048, reduced_batch=1, reduced_resolution_t=1,
        data_mres_size: Optional[Dict[int, int]] = None,
        add_res: Optional[Sequence[int]] = None,
        add_res_samples: Optional[Dict[int, int]] = None,
        downsample_from_res: Optional[int] = None,
        use_low_pass_filter=False, lowpass_cutoff_ratio=1.0,
        split_ratio=None, random_seed=42, data_normalizer=True,
        normalization_type="simple", num_samples_max=-1,
        eval_dataset_target=None, eval_filename=None,
        eval_saved_folder=None):
    """True multi-resolution KS (ks_naive_true_multires.py:173-535): the
    train file of each resolution's directory
    res_{R}/visc_{viscosity}_L{L}_lmax{lmax}_et{et}_nte{nte}_nt{nt}/
    KS_train_{train_s}.h5, batch and time strided, through
    ``ks_true_multires_splits``. ``num_samples_max`` is accepted and
    ignored, as the reference does; the eval_* keys are read by
    cli/common.py's eval swap."""
    data_mres_size = data_mres_size or {}
    u_by_res = {}
    for resolution in _needed_resolutions(data_mres_size,
                                          downsample_from_res):
        path = os.path.join(
            _ks_res_dir(saved_folder, resolution, viscosity, L, lmax, et,
                        nte, nt), f"KS_train_{train_s}.h5")
        if data_io.file_exists(path):
            u = data_io.read_ks_h5(path, split="train")["u"]
            u_by_res[resolution] = u[::reduced_batch, ::reduced_resolution_t]
    return ks_true_multires_splits(
        u_by_res, data_mres_size, add_res, add_res_samples,
        downsample_from_res, use_low_pass_filter, lowpass_cutoff_ratio,
        split_ratio, random_seed, data_normalizer, normalization_type)


def _add_res_list(add_res):
    if add_res is None:
        return []
    if hasattr(add_res, "__iter__") and not isinstance(add_res, str):
        return [int(r) for r in add_res]
    return [int(add_res)]


def _sample_at_resolutions(u_orig, add_res, k, seed, method):
    """k trajectories drawn with replacement from the full-resolution data
    by RandomState(seed), reduced to each resolution of ``add_res`` by a
    naive stride (ks_naive_multires.py:115-131) or spectral truncation
    (ks_resize_multires.py:143-165); larger ones are skipped. Returns
    [(res, array), ...]."""
    out = []
    src_res = u_orig.shape[-1]
    rng = np.random.RandomState(seed)
    for res in _add_res_list(add_res):
        if res > src_res:
            continue
        samp = u_orig[rng.choice(u_orig.shape[0], k, replace=True)]
        if res != src_res:
            if method == "resize":
                samp = resize_trajectories(samp, res, spatial_ndim=1,
                                           method="downsample")
            else:
                samp = samp[:, :, :: src_res // res][:, :, :res]
        out.append((samp.shape[-1], np.ascontiguousarray(
            samp, dtype=np.float32)))
    return out


def _as_res_dataset(buckets):
    if len(buckets) == 1:
        return next(iter(buckets.values()))
    return MultiResDataset(buckets)


def ks_multires_markov_dataset(filename, saved_folder, data_normalizer=True,
                               normalization_type="simple",
                               add_res=None, num_add_res_samples=0,
                               random_seed=42, multires_method="naive",
                               val_filename="KS_valid.h5",
                               test_filename="KS_test.h5",
                               reduced_batch=1, reduced_resolution=1,
                               reduced_resolution_t=1, num_samples_max=-1,
                               s=None, split_ratio=(0.8, 0.1, 0.1),
                               eval_dataset_target=None,
                               eval_filename=None,
                               eval_saved_folder=None):
    """Single-file-per-split KS multires (ks_naive_multires.py:242-340;
    ks_resize_multires.py:332-470 with multires_method='resize'): each
    split's file reduced, plus int(num_add_res_samples x ratio) extra
    trajectories from its full-resolution data at each resolution of
    ``add_res`` (RandomState(random_seed + split index)). One bucket is an
    ArrayDataset, more a MultiResDataset; the rollout slot holds the
    reduced test trajectories."""
    buckets = {n: {} for n in SPLITS}
    rollout_u = None
    red = dict(reduced_batch=reduced_batch,
               reduced_resolution=reduced_resolution,
               reduced_resolution_t=reduced_resolution_t,
               num_samples_max=num_samples_max)
    for si, (name, fn) in enumerate(zip(
            SPLITS, (filename, val_filename, test_filename))):
        path = os.path.join(os.path.abspath(saved_folder), fn)
        u_orig = data_io.read_ks_h5(path)["u"]
        u = reduce_trajectories(u_orig, spatial_ndim=1, **red)
        if s is not None:
            u = resize_trajectories(u, s, spatial_ndim=1)
        x, y = markov_pairs_1d(u)
        _merge_bucket(buckets[name], u.shape[-1], x, y)
        if name == "test":
            rollout_u = u
        k = int(num_add_res_samples * split_ratio[si])
        if k > 0:
            for key, samp in _sample_at_resolutions(
                    u_orig, add_res, k, random_seed + si, multires_method):
                _merge_bucket(buckets[name], key, *markov_pairs_1d(samp))
    rollout = (TrajectoryDataset(np.ascontiguousarray(rollout_u,
                                                      dtype=np.float32))
               if rollout_u is not None else None)
    return _package(_as_res_dataset(buckets["train"]),
                    _as_res_dataset(buckets["val"]),
                    _as_res_dataset(buckets["test"]),
                    rollout, data_normalizer, normalization_type)


def _alias_of(base):
    """Mark a delegating alias so ``inspect.signature`` resolves the base
    factory's parameters (through ``__wrapped__``), keeping the alias's
    own name and docstring."""
    def deco(fn):
        fn.__wrapped__ = base
        return fn
    return deco


@_alias_of(ks_multires_markov_dataset)
def ks_resize_multires_markov_dataset(*args, **kwargs):
    """dataloaders.ks_resize_multires.ks_multires_markov_dataset: the FFT
    resize flavor of the single-file multires strategy."""
    kwargs.setdefault("multires_method", "resize")
    return ks_multires_markov_dataset(*args, **kwargs)


def ks_pino_markov_dataset(filename, saved_folder=None, data_normalizer=True,
                           s=None, reduced_batch=1, reduced_resolution=1,
                           reduced_resolution_t=1, num_samples_max=-1,
                           split_ratio=(0.8, 0.1, 0.1),
                           normalization_type="minmax"):
    """PINO-style KS (ks_pino_resize_markov.py:115-232): one file, a
    contiguous ratio split, minmax normalization, an optional FFT resize
    to ``s``. Returns (train, val, test, min_data, max_data, min_model,
    max_model): no rollout slot, as the reference's 7-tuple."""
    if normalization_type != "minmax":
        raise ValueError("ks_pino_markov_dataset normalization is minmax "
                         f"only, got {normalization_type!r}")
    u = _ks_load(filename, saved_folder or ".", s=s,
                 reduced_batch=reduced_batch,
                 reduced_resolution=reduced_resolution,
                 reduced_resolution_t=reduced_resolution_t,
                 num_samples_max=num_samples_max)
    tr_end, va_end = split_ratio_indices(u.shape[0], split_ratio)
    parts = [u[:tr_end], u[tr_end:va_end], u[va_end:]]
    train, val, test = (ArrayDataset(*markov_pairs_1d(p)) for p in parts)
    out = _package(train, val, test, None, data_normalizer, "minmax")
    if not data_normalizer:
        return (*out[:3], None, None, None, None)
    train, val, test, _, mn_d, mx_d, mn_m, mx_m = out
    return train, val, test, mn_d, mx_d, mn_m, mx_m


# ---------------------------------------------------------------------------
# Burgers (PDEBench single file, pairing x = u[:, 1:-1], y = u[:, 2:])
# ---------------------------------------------------------------------------

def _pdebench_pairs(u):
    """(b, t, m) trajectories -> x = u[:, 1:-1], y = u[:, 2:], each
    (b (t - 2), 1, m): the PDEBench pairing, past the first snapshot."""
    x, y = u[:, 1:-1], u[:, 2:]
    b, t, m = x.shape
    return (np.ascontiguousarray(x.reshape(b * t, 1, m)),
            np.ascontiguousarray(y.reshape(b * t, 1, m)))


def _rollout_of(u) -> TrajectoryDataset:
    """The test trajectories of the contiguous ratio split
    (burger_naive_markov.py:96-110)."""
    _, va_end = split_ratio_indices(u.shape[0])
    return TrajectoryDataset(np.ascontiguousarray(u[va_end:],
                                                  dtype=np.float32))


def burger_markov_dataset(filename, saved_folder, data_normalizer=True,
                          normalization_type="minmax",
                          use_low_pass_filter=False, lowpass_cutoff_ratio=1.0,
                          reduced_batch=1, reduced_resolution=1,
                          reduced_resolution_t=1, num_samples_max=-1,
                          s=None):
    """Burgers, naive or low-passed (burger_naive_markov.py:204); ``s``
    FFT-resizes (burger_resize_markov.py:106). The PDEBench pairs split
    0.8 / 0.1 / 0.1 by the seed-42 permutation; the rollout holds the
    contiguous split's test trajectories."""
    path = os.path.join(os.path.abspath(saved_folder), filename)
    u = data_io.read_pdebench_h5(path)["u"]
    u = reduce_trajectories(
        u, reduced_batch, reduced_resolution, reduced_resolution_t,
        use_low_pass_filter, lowpass_cutoff_ratio, num_samples_max,
        spatial_ndim=1)
    if s is not None:
        u = resize_trajectories(u, s, spatial_ndim=1)
    train, val, test = _split_pairs(*_pdebench_pairs(u), seed=42)
    return _package(train, val, test, _rollout_of(u), data_normalizer,
                    normalization_type)


def burger_true_multires_markov_dataset(
        saved_folder, viscosity=0.001,
        filename_pattern="1D_Burgers_Sols_Nu*.hdf5",
        reduced_batch=1, reduced_resolution_t=1,
        data_mres_size: Optional[Dict[int, int]] = None,
        add_res=None, add_res_samples=None, downsample_from_res=None,
        use_low_pass_filter=False, lowpass_cutoff_ratio=1.0,
        add_res_method="naive", split_ratio=None, random_seed=42,
        data_normalizer=True, normalization_type="simple",
        num_samples_max=-1, eval_dataset_target=None, eval_filename=None,
        eval_saved_folder=None):
    """True multi-resolution Burgers (burger_naive_true_multires.py:61-72):
    per resolution the sorted first file of burgers_{res}_{viscosity}/
    matching ``filename_pattern`` (among the files and the paths held by
    ``data.io.files_in_memory``), batch and time strided, through
    ``ks_true_multires_splits`` with the pairs past the first snapshot;
    ``add_res_method`` 'resize' FFT-downsamples the extra resolutions
    (burger_resize_true_multires.py:251). ``num_samples_max`` is accepted
    and ignored, as the reference does; the eval_* keys are read by
    cli/common.py's eval swap."""
    data_mres_size = data_mres_size or {}
    u_by_res = {}
    for resolution in _needed_resolutions(data_mres_size,
                                          downsample_from_res):
        folder = os.path.join(saved_folder,
                              f"burgers_{resolution}_{viscosity}")
        matches = data_io.glob_files(os.path.join(folder, filename_pattern))
        if matches:
            u = data_io.read_pdebench_h5(matches[0])["u"]
            u_by_res[resolution] = u[::reduced_batch, ::reduced_resolution_t]
    return ks_true_multires_splits(
        u_by_res, data_mres_size, add_res, add_res_samples,
        downsample_from_res, use_low_pass_filter, lowpass_cutoff_ratio,
        split_ratio, random_seed, data_normalizer, normalization_type,
        # the Burgers pairs start past the first snapshot
        pair=lambda u: markov_pairs_1d(u[:, 1:]),
        add_res_method=add_res_method)


@_alias_of(burger_true_multires_markov_dataset)
def burger_resize_true_multires_markov_dataset(*args, **kwargs):
    """dataloaders.burger_resize_true_multires.
    burger_true_multires_markov_dataset: true-multires Burgers whose extra
    resolutions are FFT-downsampled."""
    kwargs.setdefault("add_res_method", "resize")
    return burger_true_multires_markov_dataset(*args, **kwargs)


def burger_multires_markov_dataset(filename, saved_folder,
                                   data_normalizer=True,
                                   normalization_type="minmax",
                                   add_res=None, num_add_res_samples=0,
                                   random_seed=42, multires_method="naive",
                                   reduced_batch=1, reduced_resolution=1,
                                   reduced_resolution_t=1,
                                   num_samples_max=-1, s=None,
                                   eval_dataset_target=None,
                                   eval_filename=None,
                                   eval_saved_folder=None):
    """Single-file Burgers multires (burger_naive_multires.py:200-320;
    burger_resize_multires.py:233-360 with multires_method='resize'): the
    reduced file's PDEBench pairs, then int(0.8 num_add_res_samples)
    trajectories of the full-resolution data at each resolution of
    ``add_res`` (``_sample_at_resolutions``, RandomState(random_seed)),
    and the combined sample list split 0.8 / 0.1 / 0.1 by the seed-42
    permutation into a bucket per width. The rollout holds the contiguous
    split's test trajectories of the reduced file."""
    path = os.path.join(os.path.abspath(saved_folder), filename)
    u_orig = data_io.read_pdebench_h5(path)["u"]
    u = reduce_trajectories(u_orig, reduced_batch, reduced_resolution,
                            reduced_resolution_t,
                            num_samples_max=num_samples_max, spatial_ndim=1)
    if s is not None:
        u = resize_trajectories(u, s, spatial_ndim=1)
    # per-resolution chunks in order: the main data first, then the extras
    chunks = [(u.shape[-1],) + _pdebench_pairs(u)]
    k = int(num_add_res_samples * 0.8)
    if k > 0:
        for key, samp in _sample_at_resolutions(
                u_orig, add_res, k, random_seed, multires_method):
            chunks.append((key,) + _pdebench_pairs(samp))
    total = sum(c[1].shape[0] for c in chunks)
    perm = _randsplit_indices(total, 42)
    tr_end = int(0.8 * total)
    va_end = tr_end + int(0.1 * total)
    split_of = np.empty(total, dtype=np.int8)
    split_of[perm[:tr_end]] = 0
    split_of[perm[tr_end:va_end]] = 1
    split_of[perm[va_end:]] = 2
    buckets = [{}, {}, {}]
    offset = 0
    for key, x, y in chunks:
        local = split_of[offset:offset + x.shape[0]]
        for si in range(3):
            sel = np.nonzero(local == si)[0]
            if sel.size:
                _merge_bucket(buckets[si], key, x[sel], y[sel])
        offset += x.shape[0]
    return _package(*(_as_res_dataset(b) for b in buckets), _rollout_of(u),
                    data_normalizer, normalization_type)


@_alias_of(burger_multires_markov_dataset)
def burger_resize_multires_markov_dataset(*args, **kwargs):
    """dataloaders.burger_resize_multires.burger_multires_markov_dataset."""
    kwargs.setdefault("multires_method", "resize")
    return burger_multires_markov_dataset(*args, **kwargs)


def burger_window_dataset(filename, saved_folder, window_size=10,
                          data_normalizer=True, reduced_batch=1,
                          reduced_resolution=1, reduced_resolution_t=1,
                          num_samples_max=-1):
    """Sliding-window Burgers for the S4-style models
    (dataloaders/burger_s4.py:13-96): x (N, window_size, m), y (N, m),
    split by the seed-42 permutation, SimpleNormalizers."""
    path = os.path.join(os.path.abspath(saved_folder), filename)
    u = data_io.read_pdebench_h5(path)["u"]
    u = reduce_trajectories(u, reduced_batch, reduced_resolution,
                            reduced_resolution_t,
                            num_samples_max=num_samples_max, spatial_ndim=1)
    train, val, test = _split_pairs(*sliding_windows(u, window_size),
                                    seed=42)
    return _package(train, val, test, _rollout_of(u), data_normalizer,
                    "simple")


def ns_window_dataset(filename, saved_folder, window_size=10,
                      data_normalizer=True, reduced_batch=1,
                      reduced_resolution=1, reduced_resolution_t=1,
                      num_samples_max=-1):
    """2D sliding windows of NS vorticity for the S4-style models
    (dataloaders/ns_s4.py:11-196): x (N, window_size, h, w), y (N, h, w),
    the windows ordered by start frame and trajectory, split by the
    seed-42 permutation, SimpleNormalizers. Reads ``.mat`` or ``.h5``
    through ``data.io.read_ns``."""
    u = data_io.read_ns(os.path.join(saved_folder, filename))[..., None]
    u = reduce_trajectories(u, reduced_batch, reduced_resolution,
                            reduced_resolution_t,
                            num_samples_max=num_samples_max, spatial_ndim=2)
    u = u[..., 0]                                      # (b, t, h, w)
    b, t, h, w = u.shape
    starts = np.arange(t - window_size)
    # window i of trajectory j at row i * b + j
    idx = starts[:, None] + np.arange(window_size)[None, :]
    xs = np.ascontiguousarray(
        np.moveaxis(u[:, idx], 0, 1).reshape(-1, window_size, h, w),
        dtype=np.float32)
    ys = np.ascontiguousarray(
        np.moveaxis(u[:, starts + window_size], 0, 1).reshape(-1, h, w),
        dtype=np.float32)
    train, val, test = _split_pairs(xs, ys, seed=42)
    return _package(train, val, test, _rollout_of(u), data_normalizer,
                    "simple")


def _single_step(a, u, split, data_normalizer, normalization_type):
    """a -> u pairs with a channel axis, split by the seed-42 permutation
    at ``split``; no rollout."""
    x = np.ascontiguousarray(a[:, None], dtype=np.float32)
    y = np.ascontiguousarray(u[:, None], dtype=np.float32)
    train, val, test = _split_pairs(x, y, split=split, seed=42)
    return _package(train, val, test, None, data_normalizer,
                    normalization_type)


def load_burger_data_from_mat(data_path1, data_path2=None, res_scale=1,
                              split=(0.8, 0.1, 0.1), data_normalizer=True,
                              normalization_type="unit_gaussian"):
    """FNO-paper Burgers .mat (the initial condition 'a' -> the solution
    'u'), a second file's samples appended (load_data.py:12-101), every
    ``res_scale``-th point. No rollout: a single-step map."""
    d = data_io.read_fno_burgers_mat(data_path1)
    a, u = d["a"], d["u"]
    if data_path2:
        d2 = data_io.read_fno_burgers_mat(data_path2)
        a, u = np.vstack([a, d2["a"]]), np.vstack([u, d2["u"]])
    if res_scale > 1:
        a, u = a[:, ::res_scale], u[:, ::res_scale]
    return _single_step(a, u, split, data_normalizer, normalization_type)


# ---------------------------------------------------------------------------
# Darcy (steady state: coefficient -> solution)
# ---------------------------------------------------------------------------

def darcy_dataset(filename, saved_folder, data_normalizer=True,
                  normalization_type="unit_gaussian", reduced_batch=1,
                  reduced_resolution=1, num_samples_max=-1,
                  reduced_resolution_t=1):
    """Steady-state Darcy flow, the coefficient field -> the pressure
    (dataloaders/darcy_loader.py:7-126): strided, the first
    ``num_samples_max``, split by the seed-42 permutation; no rollout.
    ``reduced_resolution_t`` is accepted and ignored (no time axis; the
    yaml carries it)."""
    path = os.path.join(os.path.abspath(saved_folder), filename)
    d = data_io.read_darcy_h5(path)
    a = d["a"][::reduced_batch, ::reduced_resolution, ::reduced_resolution]
    u = d["u"][::reduced_batch, ::reduced_resolution, ::reduced_resolution]
    if num_samples_max > 0:
        a, u = a[:num_samples_max], u[:num_samples_max]
    return _single_step(a, u, (0.8, 0.1, 0.1), data_normalizer,
                        normalization_type)


def load_darcy_data_from_mat(data_path, res_scale=1, split=(0.8, 0.1, 0.1),
                             data_normalizer=True,
                             normalization_type="unit_gaussian"):
    """FNO-paper Darcy .mat ('coeff' -> 'sol', load_data.py:182), every
    ``res_scale``-th point along each axis."""
    d = data_io.read_fno_darcy_mat(data_path)
    a, u = d["a"], d["u"]
    if res_scale > 1:
        a = a[:, ::res_scale, ::res_scale]
        u = u[:, ::res_scale, ::res_scale]
    return _single_step(a, u, split, data_normalizer, normalization_type)


def load_darcy_data(saved_folder="2D_DarcyFlow_beta0.01", ntrain=9000,
                    ntest=1000, x_file="nu.npy", y_file="tensor.npy"):
    """Legacy PDEBench Darcy .npy loader (load_data.py:276-313): x from
    ``x_file``, y from ``y_file``, a channel axis added to (n, h, w)
    arrays, the first ``ntrain`` for training and the next ``ntest`` for
    testing (no shuffle, no validation split), per-location
    UnitGaussianNormalizers fit on the train split. Returns the
    reference's 4-tuple (train, test, x_normalizer, y_normalizer)."""
    x = np.load(os.path.join(saved_folder, x_file)).astype(np.float32)
    y = np.load(os.path.join(saved_folder, y_file)).astype(np.float32)
    x = x[:, None] if x.ndim == 3 else x
    y = y[:, None] if y.ndim == 3 else y
    stats = fit_normalizers(x[:ntrain], y[:ntrain], "unit_gaussian")
    xn, yn = stats["x_normalizer"], stats["y_normalizer"]
    train = ArrayDataset(x[:ntrain], y[:ntrain]).encoded(xn, yn)
    test = ArrayDataset(x[ntrain:ntrain + ntest],
                        y[ntrain:ntrain + ntest]).encoded(xn, yn)
    return train, test, xn, yn


# ---------------------------------------------------------------------------
# Active matter (the Well's layout, multi-channel 2D)
# ---------------------------------------------------------------------------

def _active_matter_package(u, s, data_normalizer, normalization_type):
    """(b, t, h, w, c) trajectories, already reduced -> the factory tuple:
    FFT-resized to ``s`` (per channel), Markov pairs (N, c, h, w) split by
    the seed-42 permutation, the test trajectories (n, t, c, h, w) as the
    rollout set."""
    if s is not None:
        u = np.moveaxis(resize_trajectories(np.moveaxis(u, -1, 2), s,
                                            spatial_ndim=2), 2, -1)
    x, y = markov_pairs_2d(u)
    train, val, test = _split_pairs(x, y, seed=42)
    _, va_end = split_ratio_indices(u.shape[0])
    rollout = TrajectoryDataset(np.ascontiguousarray(
        np.moveaxis(u[va_end:], -1, 2)))
    return _package(train, val, test, rollout, data_normalizer,
                    normalization_type)


def active_matter_markov_dataset(filename, saved_folder, data_normalizer=True,
                                 normalization_type="simple",
                                 fields=("concentration",),
                                 reduced_batch=1, reduced_resolution=1,
                                 reduced_resolution_t=1, num_samples_max=-1,
                                 s=None):
    """Multi-channel 2D active matter from one file of the Well
    (active_matter_markov.py:11-164): the ``fields`` as channels,
    strided, optionally FFT-resized to ``s``."""
    path = os.path.join(os.path.abspath(saved_folder), filename)
    u = data_io.read_active_matter_h5(path, fields)  # (b, t, h, w, c)
    u = reduce_trajectories(u, reduced_batch, reduced_resolution,
                            reduced_resolution_t,
                            num_samples_max=num_samples_max, spatial_ndim=2)
    return _active_matter_package(u, s, data_normalizer, normalization_type)


def active_matter_all_markov_dataset(saved_folder, pattern="*.hdf5",
                                     fields=("concentration",),
                                     data_normalizer=True,
                                     normalization_type="simple",
                                     reduced_batch=1, reduced_resolution=1,
                                     reduced_resolution_t=1,
                                     num_samples_max=-1, s=None,
                                     max_files=None):
    """Every file of ``saved_folder`` matching ``pattern`` (sorted, the
    first ``max_files``), concatenated over trajectories
    (active_matter_all_markov.py:12-285); globbing goes through
    ``data.io.glob_files``, so files held in memory match too."""
    paths = data_io.glob_files(os.path.join(saved_folder, pattern))
    if not paths:
        raise FileNotFoundError(
            f"no files matching {pattern!r} in {saved_folder}")
    if max_files is not None:
        paths = paths[:max_files]
    u = np.concatenate([data_io.read_active_matter_h5(p, fields)
                        for p in paths], axis=0)
    u = reduce_trajectories(u, reduced_batch, reduced_resolution,
                            reduced_resolution_t,
                            num_samples_max=num_samples_max, spatial_ndim=2)
    return _active_matter_package(u, s, data_normalizer, normalization_type)


def multi_file_active_matter_markov_dataset(file_pattern, saved_folder,
                                            data_normalizer=True,
                                            s=None, max_files=None,
                                            normalization_type="minmax",
                                            reduced_batch=1,
                                            reduced_resolution=1,
                                            reduced_resolution_t=1,
                                            num_samples_max=-1,
                                            fields=("concentration",)):
    """The ns_active_t* datasets' factory (active_matter_all_markov.py:285):
    ``active_matter_all_markov_dataset`` over ``file_pattern``, minmax
    normalisation by default, the strides passed through."""
    return active_matter_all_markov_dataset(
        saved_folder, pattern=file_pattern, data_normalizer=data_normalizer,
        normalization_type=normalization_type, s=s, max_files=max_files,
        reduced_batch=reduced_batch, reduced_resolution=reduced_resolution,
        reduced_resolution_t=reduced_resolution_t,
        num_samples_max=num_samples_max, fields=fields)


def point_cloud_markov_dataset(filename, saved_folder, data_normalizer=True,
                               normalization_type="simple",
                               reduced_batch=1, reduced_resolution=1,
                               reduced_resolution_t=1, num_samples_max=-1):
    """The GNOT point-cloud dataset (the dgl-free realization of the
    reference's dataloaders/dgl_data.py:33-147): NS frames become node
    features on a normalized point cloud (``data.graph.
    grid_to_point_cloud``); x rows are [features | positions], so that
    GNOTOperator splits query, branch and gate inputs. The standard tuple
    with x (N, h*w, 2 + 1), y (N, h*w, 1) and no rollout."""
    from resolution_pde_tpu_torch.data.graph import grid_to_point_cloud

    path = os.path.join(os.path.abspath(saved_folder), filename)
    u = data_io.read_ns(path)[..., None]
    u = reduce_trajectories(u, reduced_batch, reduced_resolution,
                            reduced_resolution_t,
                            num_samples_max=num_samples_max, spatial_ndim=2)
    u = u[..., 0]  # (n, t, h, w)
    n, t, h, w = u.shape
    feats, pos = grid_to_point_cloud(u.reshape(n * t, h, w))
    feats = feats.reshape(n, t, h * w, 1)
    x_feat = feats[:, :-1].reshape(-1, h * w, 1)
    y = feats[:, 1:].reshape(-1, h * w, 1)
    pos_b = np.broadcast_to(pos[None], (x_feat.shape[0],) + pos.shape)
    x = np.concatenate([x_feat, pos_b], axis=-1).astype(np.float32)
    train, val, test = _split_pairs(x, np.ascontiguousarray(y), seed=42)
    return _package(train, val, test, None, data_normalizer,
                    normalization_type)
