"""Kuramoto-Sivashinsky solver: ETDRK4, pseudo-spectral, periodic.

Counterpart of resolution_pde_tpu/datagen/ks.py. The PDE is
u_t + u u_x + u_xx + visc u_xxxx = 0 on [0, L]; ETDRK4 (Kassam and
Trefethen 2005) with the phi-functions from a contour integral.

The state is the half spectrum (rfft). Evolving the full complex spectrum
with ``real(ifft(.))`` in the nonlinearity leaves the conjugate-asymmetric
part of the state with no nonlinear feedback, so roundoff in the linearly
unstable band grows at the linear rate and overflows; the half spectrum is
conjugate-symmetric by construction and halves the work. The state's
precision follows the initial condition's (f32 for f32 input, as the JAX
package runs it), and the inverse transforms go through the port's
``irfft``. The steps run on the initial condition's device: on the CPU
eagerly; on the card one snapshot's steps are captured once in a CUDA
graph and replayed (each step is some 70 small launches, which leave the
device idle most of the time when launched one by one).
"""

from __future__ import annotations

import numpy as np
import torch

from resolution_pde_tpu_torch.datagen.graphs import graphed
from resolution_pde_tpu_torch.ops.spectral import irfft


def _etdrk4_coeffs(lin, dt: float, n_contour: int = 32):
    """The ETDRK4 coefficients (e, e2, q, f1, f2, f3) of the linear
    operator ``lin`` (numpy, float64): the phi-functions as means over
    ``n_contour`` points of a unit circle around each eigenvalue."""
    lc = lin.astype(np.complex128) * dt
    r = np.exp(2j * np.pi * (np.arange(1, n_contour + 1) - 0.5) / n_contour)
    lr = lc[:, None] + r[None, :]
    q = np.real(np.mean((np.exp(lr / 2) - 1) / lr, axis=1)) * dt
    f1 = np.real(np.mean(
        (-4 - lr + np.exp(lr) * (4 - 3 * lr + lr ** 2)) / lr ** 3, axis=1)) * dt
    f2 = np.real(np.mean(
        (2 + lr + np.exp(lr) * (-2 + lr)) / lr ** 3, axis=1)) * dt
    f3 = np.real(np.mean(
        (-4 - 3 * lr - lr ** 2 + np.exp(lr) * (4 - lr)) / lr ** 3, axis=1)) * dt
    e = np.exp(dt * lin)
    e2 = np.exp(dt * lin / 2)
    return e, e2, q, f1, f2, f3


def solve_ks(u0: torch.Tensor, L: float = 64.0, visc: float = 1.0,
             dt: float = 0.05, n_snapshots: int = 51,
             steps_per_snapshot: int = 40,
             graph: bool | None = None) -> torch.Tensor:
    """Integrate KS from u0 (B, N). Returns (B, n_snapshots, N) float32,
    the initial condition as snapshot 0, then one every
    ``steps_per_snapshot`` steps of ``dt``. ``graph``: replay one
    snapshot's steps as a CUDA graph (default: when u0 is on the card)."""
    n = u0.shape[-1]
    real = u0.dtype
    k = 2 * np.pi * np.fft.rfftfreq(n, d=L / n)
    lin = k ** 2 - visc * k ** 4
    e, e2, q, f1, f2, f3 = (torch.as_tensor(c, dtype=real, device=u0.device)
                            for c in _etdrk4_coeffs(lin, dt))
    half_ik = -0.5 * torch.as_tensor(1j * k, device=u0.device).to(
        torch.complex64 if real == torch.float32 else torch.complex128)
    dealias = torch.as_tensor(k <= (2.0 / 3.0) * k.max(), dtype=real,
                              device=u0.device)

    def nonlin(v):
        u = irfft(v, n=n)
        return half_ik * torch.fft.rfft(u * u) * dealias

    def step(v):
        nv = nonlin(v)
        a = e2 * v + q * nv
        na = nonlin(a)
        b = e2 * v + q * na
        nb = nonlin(b)
        c = e2 * a + q * (2 * nb - nv)
        nc = nonlin(c)
        return e * v + nv * f1 + 2 * (na + nb) * f2 + nc * f3

    def snapshot(v):
        for _ in range(steps_per_snapshot):
            v = step(v)
        return v

    v = torch.fft.rfft(u0)
    if (u0.is_cuda if graph is None else graph) and n_snapshots > 1:
        snapshot = graphed(snapshot, v)
    snaps = [u0]
    for _ in range(n_snapshots - 1):
        v = snapshot(v)
        snaps.append(irfft(v, n=n))
    return torch.stack(snaps, dim=1).to(torch.float32)


def ks_initial_conditions(amps: torch.Tensor, phases: torch.Tensor,
                          size: int, L: float = 64.0) -> torch.Tensor:
    """Band-limited initial conditions on ``size`` points of [0, L):
    u0(x) = sum_l amps[:, l-1] sin(2 pi l x / L + phases[:, l-1]) for
    l = 1 .. lmax. amps, phases: (n, lmax). Returns (n, size)."""
    lmax = amps.shape[-1]
    x = np.arange(size) / size * L
    arg = torch.as_tensor((2 * np.pi / L) * np.outer(np.arange(1, lmax + 1),
                                                       x),
                          dtype=amps.dtype, device=amps.device)
    return torch.sum(amps[:, :, None]
                     * torch.sin(arg[None] + phases[:, :, None]), dim=1)


def random_ks_draws(generator: torch.Generator, n: int,
                    lmax: int = 8) -> tuple:
    """The random part of ``random_ks_initial_conditions``: amplitudes
    N(0, 1) and phases U(0, 2 pi), each (n, lmax) float32 on the CPU."""
    amps = torch.randn((n, lmax), generator=generator)
    phases = torch.rand((n, lmax), generator=generator) * (2 * np.pi)
    return amps, phases


def random_ks_initial_conditions(generator: torch.Generator, n: int,
                                 size: int, L: float = 64.0, lmax: int = 8,
                                 device=None) -> torch.Tensor:
    """``n`` random band-limited initial conditions (the lmax cutoff of
    the KS directories' names) on ``size`` points, drawn from
    ``generator`` and evaluated on ``device``."""
    amps, phases = random_ks_draws(generator, n, lmax)
    return ks_initial_conditions(amps.to(device), phases.to(device), size, L)
