"""FFNO factorized spectral convolution, channels-last.

Counterpart of resolution_pde_tpu/ops/spectral.py: the ``torch.fft`` paths
(FNO's ``spectral_conv_1d`` and ``spectral_conv_2d``,
``factorized_spectral_conv_1d`` of FFNO1D, and
``factorized_spectral_conv_2d``, the plain reference of the whole pass),
the truncated-DFT factors ``_dft_matrices`` the kernels use, and the
f32-exact fused path ``factorized_spectral_conv_2d_pallas``.
``factorized_spectral_conv_2d_slabs`` and ``spectral_conv_2d_slabs`` are
the FFNO and FNO convs on the slabs of a grid whose H axis is sharded over
"spatial" (parallel/spatial.py). Each axis uses
``m = min(n_modes, n // 2 + 1)`` modes with the weight sliced to match, so
one weight set serves every resolution. ``irfft``, ``irfft2`` and
``irfftn`` are the inverse real transforms of the port's ``torch.fft``
paths: they read the DC and Nyquist bins as real on the card too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from resolution_pde_tpu_torch.parallel import spatial


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


def irfftn(x, s, dim=None, norm: str = "backward"):
    """``torch.fft.irfftn`` as numpy computes it: the full inverse FFT along
    every axis of ``dim`` but the last (by default the last ``len(s)``
    axes), then ``irfft`` along the last, so the last axis's DC and Nyquist
    bins are read as real even where a product of spectra left them
    complex."""
    dims = tuple(range(-len(s), 0)) if dim is None else tuple(dim)
    if len(dims) != len(s):
        raise ValueError(f"irfftn: {len(s)} sizes for {len(dims)} axes")
    if len(dims) > 1:
        x = torch.fft.ifftn(x, s=s[:-1], dim=dims[:-1], norm=norm)
    return irfft(x, s[-1], dim=dims[-1], norm=norm)


def irfft2(x, s, norm: str = "backward"):
    """``torch.fft.irfft2`` over the last two axes as numpy computes it
    (``irfftn`` over two axes)."""
    return irfftn(x, s, norm=norm)


def _complex(weight):
    """Real storage with a trailing (re, im) axis as a complex tensor."""
    return torch.complex(weight[..., 0], weight[..., 1])


def spectral_conv_1d(x, weights, modes: int):
    """FNO's 1D spectral conv. x: (B, C_in, X) real; weights: (C_in, C_out,
    modes, 2). Returns (B, C_out, X): backward-norm rfft, the first
    ``modes`` bins mixed by the weights, ``irfft`` of the zero-padded
    spectrum (a kept Nyquist bin is read as real)."""
    n = x.shape[-1]
    n_freq = n // 2 + 1
    if modes > n_freq:
        raise ValueError(f"modes={modes} exceeds available frequencies "
                         f"{n_freq}")
    x_ft = torch.fft.rfft(x, dim=-1)
    out_ft = torch.einsum("bix,iox->box", x_ft[..., :modes],
                          _complex(weights))
    return irfft(out_ft, n=n, dim=-1)


def spectral_conv_2d(x, weights1, weights2, modes1: int, modes2: int):
    """FNO's 2D spectral conv. x: (B, C_in, H, W) real; weights1/weights2:
    (C_in, C_out, modes1, modes2, 2), mixing the low ([:modes1]) and the
    high ([-modes1:]) corner of the first spatial axis over the first
    ``modes2`` bins of the last. Returns (B, C_out, H, W) through
    ``irfft2`` (the mixed DC and Nyquist columns are complex; the inverse
    reads them as numpy does). The corners must not overlap: 2 modes1 <=
    H, and modes2 <= W // 2 + 1."""
    h, w = x.shape[-2], x.shape[-1]
    n_freq = w // 2 + 1
    if 2 * modes1 > h or modes2 > n_freq:
        raise ValueError(f"modes ({modes1},{modes2}) exceed spectrum "
                         f"({h // 2},{n_freq})")
    x_ft = torch.fft.rfft2(x)
    sub = "bixy,ioxy->boxy"
    lo = torch.einsum(sub, x_ft[:, :, :modes1, :modes2], _complex(weights1))
    hi = torch.einsum(sub, x_ft[:, :, h - modes1:, :modes2],
                      _complex(weights2))
    mid = lo.new_zeros((lo.shape[0], lo.shape[1], h - 2 * modes1, modes2))
    # irfft2 zero-pads the last axis from modes2 to W // 2 + 1 bins
    return irfft2(torch.cat([lo, mid, hi], dim=2), s=(h, w))


@functools.lru_cache(maxsize=64)
def _partial_dft(h: int, modes1: int, start: int, stop: int):
    """FNO2d's H transform at rows [start, stop) of h: (rows, 2 modes1)
    forward factors e^{-2 pi i k r / h} and (2 modes1, rows) inverse ones
    e^{2 pi i k r / h} / h, k the kept frequencies (the first and the last
    modes1), as complex64 numpy arrays computed in float64."""
    k = np.concatenate([np.arange(modes1), np.arange(h - modes1, h)])
    r = np.arange(start, stop)
    ang = 2.0 * np.pi * ((r[:, None] * k[None, :]) % h) / h
    return (np.exp(-1j * ang).astype(np.complex64),
            (np.exp(1j * ang.T) / h).astype(np.complex64))


def spectral_conv_2d_slabs(x, weights1, weights2, modes1: int, modes2: int,
                           shard):
    """``spectral_conv_2d`` on this rank's slab x (B, C_in, H/S, W) of a
    grid sharded over "spatial" (``shard``): the rfft along W on the slab,
    the kept H frequencies as a partial DFT over the rank's rows summed
    over "spatial" (a sum whose backward sums again: each rank evaluates
    the inverse at its own rows), the mix, the inverse along H at the
    rank's rows, then ``irfft`` along W. Returns (B, C_out, H/S, W)."""
    hs, w = x.shape[-2], x.shape[-1]
    h = hs * shard.size
    n_freq = w // 2 + 1
    if 2 * modes1 > h or modes2 > n_freq:
        raise ValueError(f"modes ({modes1},{modes2}) exceed spectrum "
                         f"({h // 2},{n_freq})")
    rows = shard.rows(h)
    fwd, inv = (torch.as_tensor(a, device=x.device)
                for a in _partial_dft(h, modes1, rows.start, rows.stop))
    x_ft = torch.fft.rfft(x)[..., :modes2]               # (B, C, H/S, m2)
    z = torch.einsum("bchy,hk->bcky", x_ft, fwd)          # (B, C, 2m1, m2)
    z = torch.view_as_complex(spatial.all_reduce_sum(
        torch.view_as_real(z), shard.group))
    sub = "bixy,ioxy->boxy"
    spec = torch.cat([torch.einsum(sub, z[:, :, :modes1], _complex(weights1)),
                      torch.einsum(sub, z[:, :, modes1:], _complex(weights2))],
                     dim=2)
    out = torch.einsum("boky,kh->bohy", spec, inv)       # (B, O, H/S, m2)
    return irfft(out, n=w, dim=-1)


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


def factorized_spectral_conv_2d_slabs(x, weight_y, weight_x, n_modes: int,
                                     shard, fft_norm: str = "ortho"):
    """``factorized_spectral_conv_2d`` on this rank's slab x (B, H/S, W, C)
    of a grid sharded over "spatial" (``shard``): the W pass on the slab,
    the H pass on the pencils (B, C, H, W/S) of an all-to-all and back."""
    xc = x.permute(0, 3, 1, 2)  # (B, C, H/S, W)
    yy = _axis_pass_fft(xc, weight_y, n_modes, 3, fft_norm)
    pencil = spatial.slab_to_pencil(xc, shard.group, h_dim=2, w_dim=3)
    xx = spatial.pencil_to_slab(
        _axis_pass_fft(pencil, weight_x, n_modes, 2, fft_norm), shard.group,
        h_dim=2, w_dim=3)
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
