"""1D viscous Burgers solver, pseudo-spectral, periodic.

Counterpart of resolution_pde_tpu/datagen/burgers.py: u_t + u u_x = nu
u_xx on [0, 1), Crank-Nicolson for the diffusion and an explicit step of
the advection term, dealiased by the 2/3 rule, on the half spectrum
(rfft), ``steps_per_snapshot`` steps of ``dt`` between snapshots. Writes
PDEBench's layout through ``datagen.writers.write_pdebench_file``. The
state is complex64 with float32 constants, as the JAX package computes
it, and the inverse transforms go through the port's ``irfft``. The
steps run on the initial condition's device: on the CPU eagerly; on the
card one snapshot's steps are captured once in a CUDA graph and replayed
(a step is some ten small launches).
"""

from __future__ import annotations

import numpy as np
import torch

from resolution_pde_tpu_torch.datagen.graphs import graphed
from resolution_pde_tpu_torch.ops.spectral import irfft


def solve_burgers(u0: torch.Tensor, nu: float = 1e-3, dt: float = 1e-4,
                  n_snapshots: int = 201, steps_per_snapshot: int = 100,
                  graph: bool | None = None) -> torch.Tensor:
    """Integrate Burgers from u0 (B, N) float32 on [0, 1). Returns (B,
    n_snapshots, N) float32, the initial condition as snapshot 0.
    ``graph``: replay one snapshot's steps as a CUDA graph (default: when
    u0 is on the card)."""
    n = u0.shape[-1]
    dev = u0.device
    k = 2 * np.pi * np.fft.rfftfreq(n, d=1.0 / n)
    lap = -(k ** 2)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    cn_num = f32(1.0 + 0.5 * dt * nu * lap)
    cn_den = f32(1.0 - 0.5 * dt * nu * lap)
    half_ik = -0.5 * torch.as_tensor(1j * k, dtype=torch.complex64,
                                     device=dev)
    dealias = f32(k <= (2.0 / 3.0) * k.max())

    def step(v):
        u = irfft(v, n=n)
        nl = half_ik * torch.fft.rfft(u * u) * dealias
        return (cn_num * v + dt * nl) / cn_den

    def snapshot(v):
        for _ in range(steps_per_snapshot):
            v = step(v)
        return v

    v = torch.fft.rfft(u0.to(torch.float32))
    if (u0.is_cuda if graph is None else graph) and n_snapshots > 1:
        snapshot = graphed(snapshot, v)
    snaps = [u0.to(torch.float32)]
    for _ in range(n_snapshots - 1):
        v = snapshot(v)
        snaps.append(irfft(v, n=n))
    return torch.stack(snaps, dim=1)
