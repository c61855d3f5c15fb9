"""Steady-state 2D Darcy flow: thresholded random coefficients and their
pressure fields, by a batched conjugate-gradient solve.

Counterpart of resolution_pde_tpu/datagen/darcy.py (the reference has no
Darcy generator; its darcy family reads PDEBench's
darcy_flow_beta_*.hdf5):

    -div( a(x) grad u(x) ) = beta   on (0, 1)^2,   u = 0 on the boundary,

a(x) piecewise constant, a_plus where a Gaussian random field is >= 0 and
a_minus elsewhere (the FNO paper's 12 / 3). The operator is the
five-point finite-volume stencil with harmonic face averages and a
ghost-cell Dirichlet wall; the solve is Jacobi-preconditioned CG from
zero, each sample stopping on JAX's rule (``jax.scipy.sparse.linalg.cg``
under ``vmap``): the unpreconditioned ||r||^2 <= tol^2 ||b||^2, or
``maxiter`` iterations. A converged sample is frozen by a mask while the
others go on, and the host reads whether any is still running only every
``CHECK_EVERY`` iterations (each read is a sync with the device).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from resolution_pde_tpu_torch.datagen.random_fields import GaussianRF

CHECK_EVERY = 32


def _face_coeffs(a):
    """Harmonic-mean face coefficients of cell-centred (..., s, s) fields:
    ax (..., s, s-1) between columns, ay (..., s-1, s) between rows."""
    ax = 2.0 * a[..., :, :-1] * a[..., :, 1:] / (a[..., :, :-1]
                                                 + a[..., :, 1:])
    ay = 2.0 * a[..., :-1, :] * a[..., 1:, :] / (a[..., :-1, :]
                                                 + a[..., 1:, :])
    return ax, ay


def _edges(a):
    """2 a on the boundary cells, once per wall they touch (corners
    twice), zero inside: the ghost-cell Dirichlet closure's coefficient
    at half a cell's distance."""
    wall = torch.zeros_like(a)
    wall[..., :, 0] += 2.0 * a[..., :, 0]
    wall[..., :, -1] += 2.0 * a[..., :, -1]
    wall[..., 0, :] += 2.0 * a[..., 0, :]
    wall[..., -1, :] += 2.0 * a[..., -1, :]
    return wall


def _stencil(a):
    """u -> -div(a grad u) on (..., s, s) cell grids with u = 0 ghosts
    beyond the walls, grid spacing 1 / s; the coefficients are computed
    once."""
    h2 = (1.0 / a.shape[-1]) ** 2
    ax, ay = _face_coeffs(a)
    wall = _edges(a)

    def apply(u):
        # the flux through each interior face; a cell takes its east
        # (south) face's minus its west (north) face's
        dx = ax * (u[..., :, 1:] - u[..., :, :-1])
        dy = ay * (u[..., 1:, :] - u[..., :-1, :])
        lap = (F.pad(dx, (0, 1)) - F.pad(dx, (1, 0))
               + F.pad(dy, (0, 0, 0, 1)) - F.pad(dy, (0, 0, 1, 0)))
        return -(lap - wall * u) / h2

    return apply


def _apply_operator(a, u):
    """-div(a grad u) (JAX ``_apply_operator``, batched)."""
    return _stencil(a)(u)


def _jacobi_diagonal(a):
    """The operator's diagonal: the sum of a cell's face coefficients and
    its wall terms, over h^2."""
    s = a.shape[-1]
    ax, ay = _face_coeffs(a)
    diag = (F.pad(ax, (0, 1)) + F.pad(ax, (1, 0))
            + F.pad(ay, (0, 0, 0, 1)) + F.pad(ay, (0, 0, 1, 0)))
    return (diag + _edges(a)) / (1.0 / s) ** 2


def _dot(x, y):
    """Per-sample sums of x y over the last two axes."""
    return (x * y).sum(dim=(-2, -1))


def _solve_darcy_batch(a, beta: float, tol: float, maxiter: int) -> tuple:
    """Jacobi-preconditioned CG for -div(a grad u) = beta on every sample
    of ``a`` (n, s, s), JAX's ``cg`` step for step, a sample frozen once
    its ||r||^2 <= tol^2 ||b||^2. Returns (u, the relative residuals
    ||A u - b|| / ||b|| (n,), the iterations run)."""
    op = _stencil(a)
    b = torch.full_like(a, float(beta))
    diag = _jacobi_diagonal(a)
    atol2 = (tol ** 2) * _dot(b, b)
    x = torch.zeros_like(b)
    r = b - op(x)
    p = r / diag
    gamma = _dot(r, p)
    for it in range(maxiter):
        active = _dot(r, r) > atol2
        if it % CHECK_EVERY == 0 and not bool(active.any()):
            break
        ap = op(p)
        alpha = gamma / _dot(p, ap)
        x_ = x + alpha[:, None, None] * p
        r_ = r - alpha[:, None, None] * ap
        z_ = r_ / diag
        gamma_ = _dot(r_, z_)
        p_ = z_ + (gamma_ / gamma)[:, None, None] * p
        keep = active[:, None, None]
        x = torch.where(keep, x_, x)
        r = torch.where(keep, r_, r)
        p = torch.where(keep, p_, p)
        gamma = torch.where(active, gamma_, gamma)
    else:
        it = maxiter
    res = (torch.linalg.vector_norm(op(x) - b, dim=(-2, -1))
           / torch.linalg.vector_norm(b, dim=(-2, -1)))
    return x, res, it


def solve_darcy(a, beta: float = 1.0, tol: float = 1e-6,
                maxiter: int | None = None, max_residual: float = 1e-2,
                info: dict | None = None) -> torch.Tensor:
    """Solve -div(a grad u) = beta for a batch of coefficient fields ``a``
    (n, s, s), positive, float32, on a's device (CG, ``maxiter`` default
    40 s). Raises if any sample's relative residual ||A u - b|| / ||b||
    exceeds ``max_residual`` or is not finite: an unconverged solve is
    never returned. ``info``, when given, receives the iterations run and
    the residuals."""
    a = torch.as_tensor(a, dtype=torch.float32)
    if maxiter is None:
        maxiter = 40 * a.shape[-1]
    u, res, iters = _solve_darcy_batch(a, float(beta), float(tol),
                                       int(maxiter))
    res = res.cpu().numpy()
    if info is not None:
        info.update(iterations=iters, residuals=res)
    if not np.isfinite(res).all() or res.max() > max_residual:
        raise RuntimeError(
            f"Darcy CG failed to converge: relative residuals "
            f"{res.tolist()} (gate {max_residual}); raise maxiter "
            f"({maxiter}) or loosen the gate")
    return u


def generate_darcy_dataset(generator: torch.Generator, n_samples: int,
                           s: int = 128, beta: float = 1.0,
                           a_plus: float = 12.0, a_minus: float = 3.0,
                           alpha: float = 2.0, tau: float = 3.0,
                           batch_size: int = 32, device=None,
                           info: list | None = None) -> tuple:
    """PDEBench-style Darcy data: coefficients thresholded from GRF(alpha,
    tau) fields drawn from ``generator``, solved ``batch_size`` samples at
    a time on ``device``. Returns (a (n, s, s), u (n, s, s)) float32
    numpy; ``info``, when given, receives each batch's solve record
    (``solve_darcy``'s ``info``)."""
    grf = GaussianRF(2, s, alpha=alpha, tau=tau)
    a_out, u_out = [], []
    for start in range(0, n_samples, batch_size):
        z = grf.sample(generator, min(batch_size, n_samples - start), device)
        a = torch.where(z >= 0, a_plus, a_minus)
        record = {}
        u = solve_darcy(a, beta=beta, info=record)
        if info is not None:
            info.append(record)
        a_out.append(a.cpu().numpy())
        u_out.append(u.cpu().numpy())
    return np.concatenate(a_out), np.concatenate(u_out)
