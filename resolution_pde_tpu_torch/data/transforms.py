"""Host-side transforms of trajectories: batch and time strides, spatial
reduction (naive stride, spectral low-pass or FFT resize), Markov pairing,
the S4 family's sliding windows and split boundaries.

Counterpart of resolution_pde_tpu/data/transforms.py (reference
dataloaders/ks_naive_markov.py:253-280, ns_naive_markov.py:218-272). The
arrays are numpy on the host; the spectral transforms run through
``ops.resize`` on CPU tensors, the data path's own work.
"""

from __future__ import annotations

import numpy as np
import torch

from resolution_pde_tpu_torch.ops.resize import (
    fft_downsample_1d,
    fft_downsample_2d,
    fft_resize_1d,
    fft_resize_2d,
    lowpass_filter_1d,
    lowpass_filter_2d,
)


def _host(fn, u: np.ndarray, *args, **kw) -> np.ndarray:
    """fn on a CPU float32 tensor view of u, back to a float32 array."""
    t = torch.from_numpy(np.ascontiguousarray(u, dtype=np.float32))
    return fn(t, *args, **kw).numpy().astype(np.float32, copy=False)


def lowpass_1d(u: np.ndarray, cutoff: float) -> np.ndarray:
    """The 1D low-pass along the last axis of (b, t, s), shape-preserving."""
    return _host(lowpass_filter_1d, u, cutoff_ratio=cutoff)


def lowpass_2d_channels_last(u: np.ndarray, cutoff: float) -> np.ndarray:
    """The 2D low-pass over the spatial axes 2 and 3 of (b, t, h, w, c)."""
    u_cf = np.moveaxis(u, -1, 2)
    return np.moveaxis(_host(lowpass_filter_2d, u_cf, cutoff_ratio=cutoff),
                       2, -1)


def reduce_trajectories(
    u: np.ndarray,
    reduced_batch: int = 1,
    reduced_resolution: int = 1,
    reduced_resolution_t: int = 1,
    use_low_pass_filter: bool = False,
    lowpass_cutoff_ratio: float = 1.0,
    num_samples_max: int = -1,
    spatial_ndim: int = 1,
) -> np.ndarray:
    """Batch and time strides and spatial reduction of trajectories.

    u: (batch, time, *spatial[, channels for 2D]), spatial_ndim 1 or 2.
    With use_low_pass_filter the data is FILTERED at full resolution (no
    subsampling): the reference's "anti-aliased naive" strategy.
    """
    u = u[::reduced_batch, ::reduced_resolution_t]
    if reduced_resolution > 1:
        if use_low_pass_filter:
            cutoff = (1.0 / reduced_resolution) * lowpass_cutoff_ratio
            if spatial_ndim == 1:
                u = lowpass_1d(u, cutoff)
            elif u.ndim == 5:
                u = lowpass_2d_channels_last(u, cutoff)
            else:
                u = _host(lowpass_filter_2d, u, cutoff_ratio=cutoff)
        elif spatial_ndim == 1:
            u = u[:, :, ::reduced_resolution]
        else:
            u = u[:, :, ::reduced_resolution, ::reduced_resolution]
    if num_samples_max > 0:
        u = u[: min(num_samples_max, u.shape[0])]
    return np.ascontiguousarray(u, dtype=np.float32)


def resize_trajectories(u: np.ndarray, s: int, spatial_ndim: int = 1,
                        method: str = "resize") -> np.ndarray:
    """FFT-based spatial resize of trajectories to size s (the "resize"
    strategy, dataloaders/*_resize_*.py); method "downsample" truncates
    the spectrum instead."""
    if spatial_ndim == 1:
        if u.shape[-1] == s:
            return np.asarray(u, dtype=np.float32)
        fn = fft_resize_1d if method == "resize" else fft_downsample_1d
        return _host(fn, u, s)
    if u.shape[-1] == s and u.shape[-2] == s:
        return np.asarray(u, dtype=np.float32)
    if method == "resize":
        return _host(fft_resize_2d, u, (s, s))
    return _host(fft_downsample_2d, u, s)


def markov_pairs_1d(u: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """u: (b, t, s) -> x, y each (b*(t-1), 1, s)."""
    x, y = u[:, :-1], u[:, 1:]
    b, t, s = x.shape
    return (np.ascontiguousarray(x.reshape(b * t, 1, s)),
            np.ascontiguousarray(y.reshape(b * t, 1, s)))


def markov_pairs_2d(u: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """u: (b, t, h, w, c) -> x, y each (b*(t-2), c, h, w). NS pairing skips
    the first step: x = u[:, 1:-1], y = u[:, 2:] (ns_naive_markov.py:258)."""
    x, y = u[:, 1:-1], u[:, 2:]
    b, t, h, w, c = x.shape
    x = np.moveaxis(x, -1, 2).reshape(b * t, c, h, w)
    y = np.moveaxis(y, -1, 2).reshape(b * t, c, h, w)
    return np.ascontiguousarray(x), np.ascontiguousarray(y)


def split_ratio_indices(n: int, split_ratio=(0.8, 0.1, 0.1)):
    """Contiguous train/val/test split boundaries, truncated to ints
    (burger_naive_markov.py:96-100)."""
    train_end = int(n * split_ratio[0])
    return train_end, train_end + int(n * split_ratio[1])


def sliding_windows(u: np.ndarray, window_size: int):
    """Sequence windows for S4-style models (dataloaders/burger_s4.py:
    49-77): inputs u[:, i:i+w], target u[:, i+w] for every valid i, the
    windows of one i for every trajectory together.

    u: (b, t, s) -> x (N, window_size, s), y (N, s), N = b (t - w).
    """
    b, t, s = u.shape
    n_win = t - window_size
    if n_win <= 0:
        raise ValueError(f"window_size {window_size} >= trajectory length {t}")
    x = np.stack([u[:, i:i + window_size] for i in range(n_win)])
    y = np.stack([u[:, i + window_size] for i in range(n_win)])
    return (np.ascontiguousarray(x.reshape(b * n_win, window_size, s),
                                 dtype=np.float32),
            np.ascontiguousarray(y.reshape(b * n_win, s), dtype=np.float32))
