"""FFNO factorized spectral convolution, channels-last.

Counterpart of resolution_pde_tpu/ops/spectral.py: the ``torch.fft`` path
(``factorized_spectral_conv_2d``, the plain reference of the whole pass),
the truncated-DFT factors ``_dft_matrices`` the kernels use, and the
f32-exact fused path ``factorized_spectral_conv_2d_pallas``. Each axis uses
``m = min(n_modes, n // 2 + 1)`` modes with the weight sliced to match, so
one weight set serves every resolution.
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
    return torch.fft.irfft(out_ft, n=n, dim=dim, norm=fft_norm)


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
    """Both axis passes through the fused spectral kernel in f32 (IEEE f32
    products, no TF32): the f32-exact path. x: (B, H, W, C) -> f32."""
    from resolution_pde_tpu_torch.ops.kernels.spectral_mix import (
        factorized_spectral_conv_2d_pallas2)

    return factorized_spectral_conv_2d_pallas2(
        x.float(), weight_y, weight_x, n_modes, fft_norm,
        compute_dtype=torch.float32)
