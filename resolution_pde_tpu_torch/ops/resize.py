"""FFT-based resampling: spectral downsample, resize (up and down), and
low-pass filtering. These define the "resize" and anti-aliased "naive"
resolution strategies.

Counterpart of resolution_pde_tpu/ops/resize.py (reference
utils/res_utils.py and utils/low_pass_filter.py), on ``torch.fft``. The
functions take float32 tensors of any leading shape and return float32
tensors on the same device; the transforms run in complex64, as the JAX
package's do without x64. The inverse real transforms are
``ops.spectral``'s ``irfft`` and ``irfft2``, which read the DC and Nyquist
bins as numpy does on the card too.
"""

from __future__ import annotations

import numpy as np
import torch

from resolution_pde_tpu_torch.ops.spectral import irfft, irfft2


def _band_select_indices(n_old: int, n_new: int) -> np.ndarray:
    """Indices of the FFT bins whose frequency lies in
    [-n_new/2, n_new/2 - 1] (scipy.fft.fftfreq selection)."""
    freqs = np.fft.fftfreq(n_old, d=1.0 / n_old)
    sel = np.logical_and(freqs >= -n_new / 2, freqs <= n_new / 2 - 1)
    return np.nonzero(sel)[0]


def _index(n_old: int, n_new: int, device) -> torch.Tensor:
    return torch.from_numpy(_band_select_indices(n_old, n_new)).to(device)


def fft_downsample_1d(u: torch.Tensor, n_new: int) -> torch.Tensor:
    """Spectral truncation along the last axis. u: (..., N_old)."""
    idx = _index(u.shape[-1], n_new, u.device)
    u_hat = torch.fft.fft(u, dim=-1, norm="forward")
    return torch.fft.ifft(u_hat[..., idx], dim=-1, norm="forward").real


def fft_downsample_2d(u: torch.Tensor, n_new: int) -> torch.Tensor:
    """Spectral truncation along the last two axes. u: (..., N, N)."""
    idx = _index(u.shape[-2], n_new, u.device)
    u_hat = torch.fft.fft2(u, dim=(-2, -1), norm="forward")
    u_hat = u_hat[..., idx, :][..., :, idx]
    return torch.fft.ifft2(u_hat, dim=(-2, -1), norm="forward").real


def fft_resize_1d(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """FFT interpolation along the last axis, amplitude rescaled by
    out_size / in_size (utils/res_utils.py:93-125)."""
    in_size = x.shape[-1]
    f = torch.fft.rfft(x, dim=-1, norm="backward")
    out_freqs = out_size // 2 + 1
    keep = min(f.shape[-1], out_freqs)
    f_z = f.new_zeros((*f.shape[:-1], out_freqs))
    f_z[..., :keep] = f[..., :keep]
    return irfft(f_z, n=out_size, dim=-1) * (out_size / in_size)


def fft_resize_2d(x: torch.Tensor, out_size) -> torch.Tensor:
    """FFT interpolation along the last two axes to out_size (H, W): the
    top ([:top1]) and bottom ([-bot1:]) frequency blocks of the first
    spatial axis are copied, amplitude rescaled by the area ratio
    (utils/res_utils.py:29-50)."""
    h_out, w_out = int(out_size[0]), int(out_size[1])
    h_in, w_in = x.shape[-2], x.shape[-1]
    f = torch.fft.rfft2(x, dim=(-2, -1), norm="backward")
    out_freqs = w_out // 2 + 1
    top1 = min((f.shape[-2] + 1) // 2, (h_out + 1) // 2)
    bot1 = min(f.shape[-2] // 2, h_out // 2)
    cols = min(f.shape[-1], out_freqs)
    f_z = f.new_zeros((*x.shape[:-2], h_out, out_freqs))
    f_z[..., :top1, :cols] = f[..., :top1, :cols]
    f_z[..., h_out - bot1:, :cols] = f[..., f.shape[-2] - bot1:, :cols]
    x_z = irfft2(f_z, (h_out, w_out))
    return x_z * (h_out / h_in) * (w_out / w_in)


def lowpass_filter_1d(data: torch.Tensor,
                      cutoff_ratio: float = 0.25) -> torch.Tensor:
    """Zero the rfft bins at index >= int(n_freqs * cutoff_ratio) along the
    last axis (utils/low_pass_filter.py:24-34). Shape-preserving."""
    n = data.shape[-1]
    f = torch.fft.rfft(data, dim=-1)
    n_freqs = f.shape[-1]
    mask = torch.from_numpy(
        (np.arange(n_freqs) < int(n_freqs * cutoff_ratio)).astype(np.float32))
    return irfft(f * mask.to(f.device), n=n, dim=-1)


def lowpass_filter_2d(data: torch.Tensor,
                      cutoff_ratio: float = 0.25) -> torch.Tensor:
    """Rectangular spectral low-pass over the last two axes: keep
    |freq| <= cutoff_ratio / 2 along both (utils/low_pass_filter.py:62-94).
    Assumes square spatial dims."""
    n = data.shape[-1]
    f = torch.fft.rfft2(data, dim=(-2, -1))
    freq = np.fft.fftfreq(n)
    keep = (np.abs(freq) <= cutoff_ratio * 0.5).astype(np.float32)
    mask = torch.from_numpy(keep[:, None] * keep[None, : n // 2 + 1])
    return irfft2(f * mask.to(f.device), (n, n))
