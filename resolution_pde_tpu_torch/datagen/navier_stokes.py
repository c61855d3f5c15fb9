"""2D Navier-Stokes in vorticity form, pseudo-spectral, periodic.

Counterpart of resolution_pde_tpu/datagen/navier_stokes.py (reference
data_generation/ns_2d.py:26-193): the stream function from a Poisson
solve in Fourier space, spectral velocities and vorticity gradients, the
nonlinear term formed in physical space with 2/3-rule dealiasing, and a
Crank-Nicolson update of the viscous term; a snapshot every
floor(steps / record_steps) steps.

As in the JAX package, the state is the full complex spectrum and each
field goes back to physical space as ``real(ifft2(.))``: complex-to-
complex transforms, so cuFFT's real-output path (whose handling of the
DC and Nyquist bins ``ops.spectral.irfft`` works around) is not used.
The linear operator -visc k^2 only damps, so the spectrum's
conjugate-asymmetric roundoff decays rather than grows. The spectrum is
complex64 and every constant float32 or complex64, as JAX computes them.
The steps run on the initial condition's device: on the CPU eagerly; on
the card one snapshot's steps are captured once in a CUDA graph and
replayed (a step is some 25 small launches).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from resolution_pde_tpu_torch.datagen.graphs import graphed
from resolution_pde_tpu_torch.datagen.random_fields import GaussianRF


def navier_stokes_2d(w0: torch.Tensor, f, visc: float, T: float,
                     delta_t: float = 1e-4, record_steps: int = 1,
                     graph: bool | None = None) -> tuple:
    """Integrate the vorticity equation from w0 (B, N, N) under the
    forcing f (N, N). Returns (sol (B, N, N, record_steps) float32, sol_t
    (record_steps,) float64 numpy): the snapshot after each
    floor(ceil(T / delta_t) / record_steps) steps. ``graph``: replay one
    snapshot's steps as a CUDA graph (default: when w0 is on the card)."""
    device = w0.device
    n = w0.shape[-1]
    k_max = n // 2
    steps = math.ceil(T / delta_t)
    record_time = steps // record_steps

    k = np.concatenate([np.arange(0, k_max), np.arange(-k_max, 0)])
    k_y = np.broadcast_to(k[None, :], (n, n)).astype(np.float32)
    k_x = np.ascontiguousarray(k_y.T)
    lap = 4 * (np.pi ** 2) * (k_x ** 2 + k_y ** 2)
    lap[0, 0] = 1.0
    dealias = ((np.abs(k_y) <= (2.0 / 3.0) * k_max)
               & (np.abs(k_x) <= (2.0 / 3.0) * k_max))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    two_pi_i = torch.tensor(2j * np.pi, dtype=torch.complex64, device=device)
    ik_x, ik_y = two_pi_i * f32(k_x), two_pi_i * f32(k_y)
    lap_t, dealias_t = f32(lap), f32(dealias)
    cn_num = 1.0 - 0.5 * delta_t * visc * lap_t
    cn_den = 1.0 + 0.5 * delta_t * visc * lap_t
    f_h = torch.fft.fft2(torch.as_tensor(f, dtype=torch.float32,
                                         device=device))[None]

    def step(w_h):
        psi_h = w_h / lap_t
        # u = psi_y, v = -psi_x
        q = torch.fft.ifft2(ik_y * psi_h).real
        v = torch.fft.ifft2(-ik_x * psi_h).real
        w_x = torch.fft.ifft2(ik_x * w_h).real
        w_y = torch.fft.ifft2(ik_y * w_h).real
        F_h = torch.fft.fft2(q * w_x + v * w_y) * dealias_t
        return (-delta_t * F_h + delta_t * f_h + cn_num * w_h) / cn_den

    def snapshot(w_h):
        for _ in range(record_time):
            w_h = step(w_h)
        return w_h

    w_h = torch.fft.fft2(w0.to(torch.float32))
    if (w0.is_cuda if graph is None else graph) and record_steps > 0:
        snapshot = graphed(snapshot, w_h)
    snaps = []
    for _ in range(record_steps):
        w_h = snapshot(w_h)
        snaps.append(torch.fft.ifft2(w_h).real)
    sol = torch.stack(snaps, dim=-1)
    sol_t = np.arange(1, record_steps + 1) * record_time * delta_t
    return sol, sol_t


def ns_forcing(s: int) -> np.ndarray:
    """The reference's forcing 0.1 (sin + cos)(2 pi (x + y)) on the s x s
    grid of [0, 1)^2 (ns_2d.py:154), float32."""
    t = np.linspace(0, 1, s, endpoint=False)
    xx, yy = np.meshgrid(t, t, indexing="ij")
    return (0.1 * (np.sin(2 * np.pi * (xx + yy))
                   + np.cos(2 * np.pi * (xx + yy)))).astype(np.float32)


def generate_ns_dataset(generator: torch.Generator, n_samples: int,
                        s: int = 256, viscosity: float = 1e-4,
                        T: float = 3.2, delta_t: float = 1e-4,
                        record_steps: int = 32, batch_size: int = 50,
                        alpha: float = 2.5, tau: float = 7.0,
                        device=None) -> tuple:
    """The reference driver (ns_2d.py:131-193): GRF(alpha, tau) initial
    conditions drawn from ``generator`` and the forcing ``ns_forcing``,
    solved ``batch_size`` trajectories at a time on ``device``. Returns
    (a (n, s, s), u (n, s, s, record_steps), t (record_steps,)), numpy."""
    grf = GaussianRF(2, s, alpha=alpha, tau=tau)
    f = ns_forcing(s)
    a_all, u_all = [], []
    sol_t = None
    for start in range(0, n_samples, batch_size):
        w0 = grf.sample(generator, min(batch_size, n_samples - start),
                        device)
        sol, sol_t = navier_stokes_2d(w0, f, viscosity, T, delta_t,
                                      record_steps)
        a_all.append(w0.cpu().numpy())
        u_all.append(sol.cpu().numpy())
    return np.concatenate(a_all), np.concatenate(u_all), sol_t
