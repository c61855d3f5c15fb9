"""Per-Fourier-mode error decomposition.

Counterpart of resolution_pde_tpu/evaluation/frequency.py (reference
utils/frequency_error.py:37-161). By Parseval the norm of the signal of
one isolated rfft bin is analytic in the spectrum, for a real signal of
length N with a backward-norm rfft,

    || irfft(delta_k . f) ||^2 = (w_k / N) |f_k|^2,

w_k = 2 for interior bins (a conjugate pair), 1 for DC and an even N's
Nyquist bin; in 2D the weight sits on the rfft axis. So the decomposition
is one FFT and weighted sums. ``spectrum_sums_*`` run on the device and
add up across batches; ``finalize_frequency_*`` turn the sums into the
curves on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _rfft_weights(n: int) -> np.ndarray:
    """Conjugate-pair multiplicity of each rfft bin of a length-n signal."""
    w = np.full(n // 2 + 1, 2.0, dtype=np.float32)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    return w


def spectrum_sums_1d(y_hat, y):
    """Per-mode sums of |F(err)|^2 and |F(y)|^2 over every leading axis.
    y_hat is reshaped (never broadcast) to y's shape: window targets carry
    no channel axis while the model emits (B, 1, X)."""
    y_hat = torch.as_tensor(y_hat).reshape(y.shape)
    f_hat = torch.fft.rfft(y_hat, dim=-1)
    f = torch.fft.rfft(torch.as_tensor(y), dim=-1)
    lead = tuple(range(f.ndim - 1))
    return ((f_hat - f).abs().square().sum(dim=lead),
            f.abs().square().sum(dim=lead))


def finalize_frequency_1d(err_sq, mag_sq, h: int, num_modes=None):
    n_freq = h // 2 + 1
    m = n_freq if num_modes is None else min(num_modes, n_freq)
    w = _rfft_weights(h)[:m]
    err_sq = np.asarray(torch.as_tensor(err_sq).cpu())
    mag_sq = np.asarray(torch.as_tensor(mag_sq).cpu())
    return (np.sqrt(err_sq[:m] * w / h), np.sqrt(mag_sq[:m] * w / h),
            np.fft.rfftfreq(h)[:m])


def decompose_error_by_frequency_1d(y_hat, y, num_modes=None):
    """y_hat, y: (B, C, H) -> (error_per_mode, magnitude_per_mode,
    frequencies), numpy arrays."""
    err_sq, mag_sq = spectrum_sums_1d(y_hat, y)
    return finalize_frequency_1d(err_sq, mag_sq, y.shape[-1], num_modes)


def spectrum_sums_2d(y_hat, y):
    """The 2D sums, over every axis before the last two."""
    y_hat = torch.as_tensor(y_hat).reshape(y.shape)
    f_hat = torch.fft.rfft2(y_hat, dim=(-2, -1))
    f = torch.fft.rfft2(torch.as_tensor(y), dim=(-2, -1))
    lead = tuple(range(f.ndim - 2))
    return ((f_hat - f).abs().square().sum(dim=lead),
            f.abs().square().sum(dim=lead))


def finalize_frequency_2d(err_sq, mag_sq, h: int, w_sz: int,
                          num_radial_bins: int = 64):
    err_sq = np.asarray(torch.as_tensor(err_sq).cpu())
    mag_sq = np.asarray(torch.as_tensor(mag_sq).cpu())
    freq_y = np.fft.fftfreq(h)
    freq_x = np.fft.fftfreq(w_sz)[: w_sz // 2 + 1]
    if w_sz % 2 == 0:
        freq_x[-1] = abs(freq_x[-1])  # rfftfreq's +0.5
    radial = np.sqrt(freq_y[:, None] ** 2 + freq_x[None, :] ** 2)
    pair_w = np.broadcast_to(_rfft_weights(w_sz)[None, :], radial.shape)
    bins = np.linspace(0, 0.5, num_radial_bins + 1)
    error_per_bin = np.zeros(num_radial_bins)
    magnitude_per_bin = np.zeros(num_radial_bins)
    norm = h * w_sz
    for i in range(num_radial_bins):
        mask = (radial >= bins[i]) & (radial < bins[i + 1])
        if not mask.any():
            continue
        error_per_bin[i] = np.sqrt(np.sum(err_sq * pair_w * mask) / norm)
        magnitude_per_bin[i] = np.sqrt(np.sum(mag_sq * pair_w * mask) / norm)
    return error_per_bin, magnitude_per_bin, (bins[:-1] + bins[1:]) / 2


def decompose_error_by_frequency_2d(y_hat, y, num_radial_bins: int = 64):
    """y_hat, y: (B, C, H, W) -> error and magnitude binned radially over
    sqrt(fy^2 + fx^2) in [0, 0.5]."""
    err_sq, mag_sq = spectrum_sums_2d(y_hat, y)
    return finalize_frequency_2d(err_sq, mag_sq, y.shape[-2], y.shape[-1],
                                 num_radial_bins)
