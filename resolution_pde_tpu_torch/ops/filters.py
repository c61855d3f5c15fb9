"""Designed low-pass filters of the filtered ("original") CNO: windowed-sinc
(Kaiser) taps for alias-free up- and downsampling and the filtered
LeakyReLU.

Counterpart of resolution_pde_tpu/ops/filters.py, with its own copy of the
numpy filter design (the taps equal JAX's byte for byte):
  - at a grid of N points the activation upsamples by ``lrelu_upsampling``
    (default 2);
  - the cutoff is f_c = 0.5 / cutoff_den cycles a sample at the low rate,
    the transition half-width half_width_mult * (0.5 - f_c);
  - filter_size * factor + 1 taps (odd: no half-sample shift), a Kaiser
    window with beta from the standard attenuation formula, unit DC gain
    (upsampling applies the factor's gain where it is called);
  - ``radial``: a radially symmetric 2D filter (a jinc under a radial
    Kaiser window) in place of the separable one.
The filters run as depthwise convolutions with wrap padding (the domain is
periodic): ``F.pad(mode="circular")`` then a correlation with the flipped
taps, which needs a pad no longer than the signal.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _kaiser_design(factor: int, filter_size: int, cutoff_den: float,
                   half_width_mult: float) -> tuple:
    """(numtaps, fc, beta) at the high rate."""
    numtaps = filter_size * factor + 1
    fc = (0.5 / cutoff_den) / factor
    half_width = (half_width_mult * (0.5 - 0.5 / cutoff_den)) / factor
    atten = 2.285 * (numtaps - 1) * np.pi * (2 * half_width) + 7.95
    beta = (0.1102 * (atten - 8.7) if atten > 50 else
            0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
            if atten > 21 else 0.0)
    return numtaps, fc, beta


@functools.lru_cache(maxsize=64)
def design_lowpass_filter(factor: int, filter_size: int = 6,
                          cutoff_den: float = 2.0001,
                          half_width_mult: float = 0.8) -> np.ndarray:
    """1D windowed-sinc interpolation taps for resampling by ``factor``:
    filter_size * factor + 1 of them, zero phase, unit DC gain, float32."""
    numtaps, fc, beta = _kaiser_design(factor, filter_size, cutoff_den,
                                       half_width_mult)
    n = np.arange(numtaps) - (numtaps - 1) / 2
    taps = 2 * fc * np.sinc(2 * fc * n)
    taps = taps * np.kaiser(numtaps, beta)
    taps = taps / taps.sum()
    return taps.astype(np.float32)


@functools.lru_cache(maxsize=64)
def design_lowpass_filter_2d_radial(factor: int, filter_size: int = 6,
                                    cutoff_den: float = 2.0001,
                                    half_width_mult: float = 0.8
                                    ) -> np.ndarray:
    """The radially symmetric 2D low-pass (``radial: true``): a circular
    ideal response (jinc) under a radial Kaiser window, unit DC gain."""
    from scipy.special import j1

    numtaps, fc, beta = _kaiser_design(factor, filter_size, cutoff_den,
                                       half_width_mult)
    n = np.arange(numtaps) - (numtaps - 1) / 2
    yy, xx = np.meshgrid(n, n, indexing="ij")
    r = np.sqrt(xx * xx + yy * yy)
    h = np.where(r < 1e-9, np.pi * fc * fc,
                 fc * j1(2.0 * np.pi * fc * np.maximum(r, 1e-9))
                 / np.maximum(r, 1e-9))
    half = (numtaps - 1) / 2
    t = np.clip(r / max(half, 1e-9), 0.0, 1.0)
    w = np.i0(beta * np.sqrt(np.maximum(1.0 - t * t, 0.0))) / np.i0(beta)
    h = h * w
    h = h / h.sum()
    return h.astype(np.float32)


def _taps(taps: np.ndarray, scale: float, like: torch.Tensor):
    """The taps flipped (a correlation with them is the convolution),
    times ``scale``, as a tensor of ``like``'s dtype and device."""
    flipped = np.ascontiguousarray(np.flip(taps * np.float32(scale)))
    return torch.from_numpy(flipped).to(like.device, like.dtype)


def _conv1d_same_last(x: torch.Tensor, taps: np.ndarray,
                      scale: float = 1.0) -> torch.Tensor:
    """Depthwise convolution along the last axis, wrap-padded to the same
    length ((k - 1) // 2 on the left, the rest on the right)."""
    k = taps.shape[0]
    pad_l = (k - 1) // 2
    n = x.shape[-1]
    xp = F.pad(x.reshape(-1, 1, n), (pad_l, k - 1 - pad_l),
               mode="circular")
    w = _taps(taps, scale, x).reshape(1, 1, k)
    return F.conv1d(xp, w).reshape(*x.shape[:-1], n)


def _conv2d_same(x: torch.Tensor, taps2d: np.ndarray,
                 scale: float = 1.0) -> torch.Tensor:
    """Depthwise 2D convolution over the last two axes, wrap-padded."""
    k = taps2d.shape[0]
    pad_l = (k - 1) // 2
    pad_r = k - 1 - pad_l
    h, w_sz = x.shape[-2:]
    xp = F.pad(x.reshape(-1, 1, h, w_sz), (pad_l, pad_r, pad_l, pad_r),
               mode="circular")
    w = _taps(taps2d, scale, x).reshape(1, 1, k, k)
    return F.conv2d(xp, w).reshape(*x.shape[:-2], h, w_sz)


def _zero_stuff(x: torch.Tensor, factor: int, ndim: int) -> torch.Tensor:
    """x on every ``factor``-th point of a grid ``factor`` times finer
    along the last ``ndim`` axes, zeros between."""
    shape = (*x.shape[:-ndim], *(s * factor for s in x.shape[-ndim:]))
    up = x.new_zeros(shape)
    if ndim == 1:
        up[..., ::factor] = x
    else:
        up[..., ::factor, ::factor] = x
    return up


def upsample_1d(x: torch.Tensor, factor: int, **design_kw) -> torch.Tensor:
    """Alias-free upsample along the last axis: zero-stuff, then filter."""
    taps = design_lowpass_filter(factor, **design_kw)
    return _conv1d_same_last(_zero_stuff(x, factor, 1), taps, factor)


def downsample_1d(x: torch.Tensor, factor: int,
                  **design_kw) -> torch.Tensor:
    """Alias-free downsample along the last axis: filter, then stride."""
    taps = design_lowpass_filter(factor, **design_kw)
    return _conv1d_same_last(x, taps)[..., ::factor]


def upsample_2d(x: torch.Tensor, factor: int, radial: bool = False,
                **design_kw) -> torch.Tensor:
    """Alias-free upsample over the last two axes: the separable
    windowed-sinc, or with ``radial`` the jinc filter."""
    if radial:
        taps = design_lowpass_filter_2d_radial(factor, **design_kw)
        return _conv2d_same(_zero_stuff(x, factor, 2), taps,
                            factor * factor)
    x = upsample_1d(x, factor, **design_kw)
    return upsample_1d(x.transpose(-1, -2), factor,
                       **design_kw).transpose(-1, -2)


def downsample_2d(x: torch.Tensor, factor: int, radial: bool = False,
                  **design_kw) -> torch.Tensor:
    if radial:
        taps = design_lowpass_filter_2d_radial(factor, **design_kw)
        return _conv2d_same(x, taps)[..., ::factor, ::factor]
    x = downsample_1d(x, factor, **design_kw)
    return downsample_1d(x.transpose(-1, -2), factor,
                         **design_kw).transpose(-1, -2)


def filtered_lrelu_2d(x: torch.Tensor, up_factor: int = 2,
                      negative_slope: float = 0.01,
                      out_factor: int | None = None, radial: bool = False,
                      **design_kw) -> torch.Tensor:
    """Alias-free activation: upsample, LeakyReLU, downsample. x: (..., H,
    W); out_factor: the downsample from the upsampled grid (default back
    to the input's size)."""
    x = upsample_2d(x, up_factor, radial=radial, **design_kw)
    x = F.leaky_relu(x, negative_slope)
    return downsample_2d(x, out_factor or up_factor, radial=radial,
                         **design_kw)
