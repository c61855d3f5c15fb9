"""Gaussian random fields, sampled in Fourier space.

Counterpart of resolution_pde_tpu/datagen/random_fields.py (reference
data_generation/random_fields.py:6-61): u = real(ifftn(sqrt_eig * xi))
with sqrt_eig = size^d sqrt(2) sigma (4 pi^2 |k|^2 + tau^2)^(-alpha/2),
the mean mode zeroed, and xi complex with standard normal real and
imaginary parts. The normals are drawn on the CPU from a
``torch.Generator`` and then moved to the device, so the card and the
CPU make the same fields from one seed; they are not ``jax.random``'s
draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class GaussianRF:
    """Fields of mean zero on the periodic grid of ``size``^``dim`` points,
    with covariance proportional to (-Laplacian + tau^2)^(-alpha)."""

    def __init__(self, dim: int, size: int, alpha: float = 2.0,
                 tau: float = 3.0, sigma: float | None = None):
        if dim not in (1, 2, 3):
            raise ValueError("dim must be 1, 2 or 3")
        self.dim = dim
        self.size_tuple = (size,) * dim
        if sigma is None:
            sigma = tau ** (0.5 * (2 * alpha - dim))
        k_max = size // 2
        k = np.concatenate([np.arange(0, k_max), np.arange(-k_max, 0)])
        ksq = sum(np.expand_dims(k, tuple(j for j in range(dim) if j != i))
                  ** 2 for i in range(dim))
        sqrt_eig = (size ** dim) * math.sqrt(2.0) * sigma * (
            (4 * math.pi ** 2 * ksq + tau ** 2) ** (-alpha / 2.0))
        sqrt_eig[(0,) * dim] = 0.0
        # float64 numpy, as computed; the samples use its float32 rounding
        self.sqrt_eig = sqrt_eig

    def normals(self, generator: torch.Generator, n: int) -> tuple:
        """The real and imaginary standard normals of ``n`` samples, each
        (n, *size) float32 on the CPU."""
        shape = (n, *self.size_tuple)
        return (torch.randn(shape, generator=generator),
                torch.randn(shape, generator=generator))

    def from_normals(self, xr, xi) -> torch.Tensor:
        """real(ifftn(sqrt_eig * (xr + i xi))) over the field's axes, on
        xr's device (numpy arrays go to the CPU). Returns (n, *size)
        float32."""
        xr = torch.as_tensor(xr, dtype=torch.float32)
        xi = torch.as_tensor(xi, dtype=torch.float32, device=xr.device)
        eig = torch.as_tensor(self.sqrt_eig, dtype=torch.float32,
                              device=xr.device)
        coeff = torch.complex(eig * xr, eig * xi)
        axes = tuple(range(1, self.dim + 1))
        # the size^d factor in sqrt_eig cancels ifftn's 1/N^d
        return torch.fft.ifftn(coeff, dim=axes).real.contiguous()

    def sample(self, generator: torch.Generator, n: int,
               device=None) -> torch.Tensor:
        """``n`` fields (n, *size) float32 on ``device``: normals drawn
        from ``generator`` on the CPU, the transform on the device."""
        xr, xi = self.normals(generator, n)
        return self.from_normals(xr.to(device), xi.to(device))
