"""FFNO factorized spectral convolution, channels-last.

Counterpart of resolution_pde_tpu/ops/spectral.py: the ``torch.fft`` paths
(``factorized_spectral_conv_1d`` of FFNO1D, and
``factorized_spectral_conv_2d``, the plain reference of the whole pass),
the truncated-DFT factors ``_dft_matrices`` the kernels use, and the
f32-exact fused path ``factorized_spectral_conv_2d_pallas``. Each axis uses
``m = min(n_modes, n // 2 + 1)`` modes with the weight sliced to match, so
one weight set serves every resolution. ``irfft`` and ``irfft2`` are the
inverse real transforms of the port's ``torch.fft`` paths: they read the
DC and Nyquist bins as real on the card too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _axis_pass_fft(xc, weight, n_modes: int, dim: int, fft_norm: str):
    """One truncated spectral pass of (B, C, H, W) along ``dim``."""
    n = xc.shape[dim]
    m = min(n_modes, n // 2 + 1)
    x_ft = torch.fft.rfft(xc, dim=dim, norm=fft_norm).narrow(dim, 0, m)
    w = torch.complex(weight[:, :, :m, 0], weight[:, :, :m, 1])
    sub = "bixy,ioy->boxy" if dim == 3 else "bixy,iox->boxy"
    out_ft = torch.einsum(sub, x_ft, w)
    # irfft zero-pads the spectrum from m to n // 2 + 1 bins
    return irfft(out_ft, n=n, dim=dim, norm=fft_norm)


def irfft(x, n: int, dim: int = -1, norm: str = "backward"):
    """``torch.fft.irfft`` reading only the real part of the DC bin and, for
    an even n, of the Nyquist bin, as numpy, pocketfft (torch on the CPU)
    and the JAX package do. cuFFT's C2R transform reads their imaginary
    parts too at some shapes (n = 128 over thousands of rows), so they
    are dropped here; a mixed spectrum's DC bin is complex."""
    m = x.shape[dim]
    # the mask is made on x's device, with no copy from the host, so the
    # transform can be captured in a CUDA graph
    idx = torch.arange(m, device=x.device)
    drop = idx == 0
    if n % 2 == 0 and m > n // 2:
        drop = drop | (idx == n // 2)
    shape = [1] * x.ndim
    shape[dim] = m
    x = torch.complex(x.real, x.imag.masked_fill(drop.reshape(shape), 0.0))
    return torch.fft.irfft(x, n=n, dim=dim, norm=norm)


def irfft2(x, s, norm: str = "backward"):
    """``torch.fft.irfft2`` over the last two axes as numpy computes it: the
    inverse FFT along the first, then ``irfft`` along the last."""
    return irfft(torch.fft.ifft(x, n=s[0], dim=-2, norm=norm), s[1], dim=-1,
                 norm=norm)


def factorized_spectral_conv_1d(x, weight, n_modes: int,
                                fft_norm: str = "ortho"):
    """x: (B, X, C) real; weight: (C, C, n_modes, 2). Returns (B, X, C):
    rfft along X, the first ``min(n_modes, X // 2 + 1)`` modes mixed by
    the weight sliced to match, and ``irfft``, which reads a kept Nyquist
    bin as real (its product with a complex weight is not)."""
    n = x.shape[-2]
    m = min(n_modes, n // 2 + 1)
    x_ft = torch.fft.rfft(x.transpose(-1, -2), dim=-1, norm=fft_norm)
    w = torch.complex(weight[:, :, :m, 0], weight[:, :, :m, 1])
    out_ft = torch.einsum("bix,iox->box", x_ft[..., :m], w)
    return irfft(out_ft, n=n, dim=-1, norm=fft_norm).transpose(-1, -2)


def truncate_modes_1d(x, n_modes: int, fft_norm: str = "ortho"):
    """x: (B, X, C) real with every mode from ``min(n_modes, X // 2 + 1)``
    on set to zero (FFNO1D's 'low-pass' mode)."""
    n = x.shape[-2]
    m = min(n_modes, n // 2 + 1)
    x_ft = torch.fft.rfft(x.transpose(-1, -2), dim=-1, norm=fft_norm)
    return irfft(x_ft[..., :m], n=n, dim=-1,
                 norm=fft_norm).transpose(-1, -2)


def factorized_spectral_conv_2d(x, weight_y, weight_x, n_modes: int,
                                fft_norm: str = "ortho"):
    """x: (B, H, W, C) real; weight_y/weight_x: (C, C, n_modes, 2), applied
    along W (the last spatial axis) and along H. Returns (B, H, W, C): the
    two passes summed in physical space."""
    xc = x.permute(0, 3, 1, 2)  # (B, C, H, W)
    yy = _axis_pass_fft(xc, weight_y, n_modes, 3, fft_norm)
    xx = _axis_pass_fft(xc, weight_x, n_modes, 2, fft_norm)
    return (xx + yy).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=64)
def _dft_matrices(n: int, m: int, norm: str):
    """Forward truncated rfft factors (n, m) and conjugate-weighted inverse
    factors (m, n), as numpy float32 (cos, sin, inv_cos, inv_sin), computed
    in float64 exactly as the JAX package computes them."""
    k = np.arange(m)[None, :]
    w = np.arange(n)[:, None]
    ang = 2.0 * np.pi * w * k / n
    scale = 1.0 / np.sqrt(n) if norm == "ortho" else 1.0
    fwd_cos = (np.cos(ang) * scale).astype(np.float32)         # (n, m)
    fwd_sin = (-np.sin(ang) * scale).astype(np.float32)        # (n, m)
    # inverse with Hermitian-symmetry weights: DC once, Nyquist once (only
    # when it is kept and n is even), every other mode twice
    weights = np.full(m, 2.0)
    weights[0] = 1.0
    if m == n // 2 + 1 and n % 2 == 0:
        weights[-1] = 1.0
    iscale = 1.0 / np.sqrt(n) if norm == "ortho" else 1.0 / n
    inv_cos = (weights[:, None] * np.cos(ang.T) * iscale).astype(np.float32)
    inv_sin = (-weights[:, None] * np.sin(ang.T) * iscale).astype(np.float32)
    return fwd_cos, fwd_sin, inv_cos, inv_sin


def factorized_spectral_conv_2d_pallas(x, weight_y, weight_x, n_modes: int,
                                       fft_norm: str = "ortho"):
    """Both axis passes through the f32 spectral kernel (IEEE f32
    products, no TF32): the f32-exact path. x: (B, H, W, C) -> f32."""
    from resolution_pde_tpu_torch.ops.kernels.spectral_mix import (
        factorized_spectral_conv_2d_pallas2)

    return factorized_spectral_conv_2d_pallas2(
        x.float(), weight_y, weight_x, n_modes, fft_norm,
        compute_dtype=torch.float32)
