"""State-space model kernels: HiPPO initialization, the S4D (diagonal) and
S4 (DPLR) convolution kernels, and the causal FFT convolution.

Counterpart of resolution_pde_tpu/ops/ssm.py (the ``jnp`` route of the S4
layers), in torch complex64. The JAX module imports JAX, so the port keeps
its own copy; the numpy initializers are the same code. Where the JAX
functions work per feature and the layers ``vmap`` them, these take the
feature (and channel) axes as leading batch dimensions that broadcast.
The recurrent-mode discretizations (``discretize_*``) are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Complex helpers and parameter transforms
# ---------------------------------------------------------------------------

PARAM_TRANSFORMS = ("none", "exp", "relu", "sigmoid", "softplus")


def cexp(z: torch.Tensor) -> torch.Tensor:
    """exp through the real decomposition e^a (cos b + i sin b), as the
    JAX package computes it."""
    if not z.is_complex():
        return torch.exp(z)
    e = torch.exp(z.real)
    im = z.imag
    return torch.complex(e * torch.cos(im), e * torch.sin(im))


def clog(z: torch.Tensor) -> torch.Tensor:
    """log through the real decomposition log|z| + i atan2(Im z, Re z)."""
    if not z.is_complex():
        return torch.log(z)
    re, im = z.real, z.imag
    return torch.complex(0.5 * torch.log(re * re + im * im),
                         torch.atan2(im, re))


def param_transform(x: torch.Tensor, kind: str = "none") -> torch.Tensor:
    """Positive-parameter transform (reference models/s4.py:650-664)."""
    if kind == "none":
        return x
    if kind == "exp":
        return torch.exp(x)
    if kind == "relu":
        # the reference adds 1e-4 to avoid exact zeros (models/s4.py:658)
        return F.relu(x) + 1e-4
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "softplus":
        return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus
    raise ValueError(f"unknown transform {kind!r}; one of {PARAM_TRANSFORMS}")


def inv_param_transform(x: np.ndarray, kind: str = "none") -> np.ndarray:
    """Inverse transform for initialization (models/s4.py:635-648); clamps
    the positive value at 1e-4 first, like the reference (this keeps the
    fourier measure's zero real parts finite)."""
    x = np.maximum(np.asarray(x, np.float64), 1e-4)
    if kind in ("none", "relu"):
        return x
    if kind == "exp":
        return np.log(x)
    if kind == "sigmoid":
        return np.log(x / (1.0 - x))
    if kind == "softplus":
        return np.log(np.expm1(x))
    raise ValueError(f"unknown transform {kind!r}; one of {PARAM_TRANSFORMS}")


def inv_param_transform_tensor(x: torch.Tensor,
                               kind: str = "none") -> torch.Tensor:
    """``inv_param_transform`` on a tensor (the dt initializers draw their
    values as tensors). Same 1e-4 clamp."""
    x = torch.clamp(x, min=1e-4)
    if kind in ("none", "relu"):
        return x
    if kind == "exp":
        return torch.log(x)
    if kind == "sigmoid":
        return torch.log(x / (1.0 - x))
    if kind == "softplus":
        return torch.log(torch.expm1(x))
    raise ValueError(f"unknown transform {kind!r}; one of {PARAM_TRANSFORMS}")


# ---------------------------------------------------------------------------
# HiPPO initialization (numpy, float64)
# ---------------------------------------------------------------------------

def hippo_legs_matrix(n: int) -> np.ndarray:
    """HiPPO-LegS transition matrix -A (models/s4.py:310 transition())."""
    q = np.arange(n, dtype=np.float64)
    col, row = np.meshgrid(q, q)
    r = 2 * q + 1
    m = -(np.where(row >= col, r, 0) - np.diag(q))
    t = np.sqrt(np.diag(2 * q + 1))
    return t @ m @ np.linalg.inv(t)


def _conj_pair_perm(n: int) -> np.ndarray:
    """Permutation taking an eigh-ascending-imag spectrum
    (-a_k, ..., -a_1, a_1, ..., a_k) to the [half, conj(half)] layout,
    where index j and j + n/2 are a conjugate pair: the layout in which
    the full-N consumers tie per-pair quantities by ``cat([dt, dt])``."""
    half = n // 2
    return np.concatenate([np.arange(half, n),
                           np.arange(half - 1, -1, -1)])


def _conj_pair_basis(lam_im: np.ndarray, v: np.ndarray):
    """Reorder an eigh-ascending (imag, eigvecs) pair into the
    [half, conj(half)] layout and fix the per-mode phase so the second
    half's eigenvectors are the exact conjugates of the first half's. Zero
    modes (degenerate at 0, e.g. the fourier measure) keep eigh's
    orthonormal vectors: conjugating could duplicate a real vector."""
    n = lam_im.shape[0]
    half = n // 2
    perm = _conj_pair_perm(n)
    lam_im, v = lam_im[perm], v[:, perm].copy()
    nz = np.abs(lam_im[:half]) > 1e-12
    v[:, half:][:, nz] = np.conj(v[:, :half][:, nz])
    return lam_im, v


def make_dplr_hippo(n: int):
    """Diagonalized HiPPO-LegS in DPLR form (models/s4.py:384-500).

    Returns (Lambda (n,) complex128, P (n,), B (n,), V) with
    A = Lambda - P P^*, in [half, conj(half)] order.
    """
    a = hippo_legs_matrix(n)
    p = np.sqrt(np.arange(n, dtype=np.float64) + 0.5)
    b = np.sqrt(2 * np.arange(n, dtype=np.float64) + 1.0)
    s = a + p[:, None] * p[None, :]
    # S is skew-symmetric + (-1/2) I; diagonalize the skew part
    s_diag = np.diagonal(s)
    lambda_real = np.mean(s_diag) * np.ones_like(s_diag)
    lambda_imag, v = np.linalg.eigh(s * -1j)
    lambda_imag, v = _conj_pair_basis(lambda_imag, v)
    p_rot = v.conj().T @ p
    b_rot = v.conj().T @ b
    return lambda_real + 1j * lambda_imag, p_rot, b_rot, v


def hippo_transition(measure: str, n: int):
    """(A (n, n), B (n,)) float64 continuous-time transition per HiPPO
    measure (models/s4.py:310-355): 'legs', 'legt' (halved for timescale),
    'fourier'/'fout' (rank correction pre-subtracted)."""
    if measure == "legs":
        a = hippo_legs_matrix(n)
        b = np.sqrt(2 * np.arange(n, dtype=np.float64) + 1.0)
        return a, b
    if measure == "legt":
        q = np.arange(n, dtype=np.float64)
        r = np.sqrt(2 * q + 1)
        j, i = np.meshgrid(q, q)
        sign = np.where(i < j, (-1.0) ** (i - j), 1.0)
        a = -(r[:, None] * sign * r[None, :])
        b = r.copy()
        return 0.5 * a, 0.5 * b
    if measure in ("fourier", "fout"):
        freqs = np.arange(n // 2, dtype=np.float64)
        d = np.stack([np.zeros(n // 2), freqs], axis=-1).reshape(-1)[1:]
        a = np.pi * (-np.diag(d, 1) + np.diag(d, -1))
        b = np.zeros(n, dtype=np.float64)
        b[0::2] = 2 ** 0.5
        b[0] = 1.0
        return a - b[:, None] * b[None, :], b
    raise ValueError(f"unknown HiPPO measure {measure!r}")


def hippo_rank_correction(measure: str, n: int, rank: int = 1) -> np.ndarray:
    """Low-rank rows P (rank, n) such that A + sum_r P_r P_r^T is normal
    (models/s4.py:357-382). legt needs rank >= 2."""
    if measure == "legs":
        base = np.sqrt(0.5 + np.arange(n, dtype=np.float64))[None]
    elif measure == "legt":
        p = np.sqrt(1.0 + 2.0 * np.arange(n, dtype=np.float64))
        p0, p1 = p.copy(), p.copy()
        p0[0::2] = 0.0
        p1[1::2] = 0.0
        base = np.stack([p0, p1], axis=0) * 2 ** -0.5
    elif measure in ("fourier", "fout"):
        p = np.zeros(n, dtype=np.float64)
        p[0::2] = 2 ** 0.5
        p[0] = 1.0
        base = p[None]
    else:
        raise ValueError(f"unknown HiPPO measure {measure!r}")
    d = base.shape[0]
    if rank < d:
        raise ValueError(
            f"measure {measure!r} needs rank >= {d}, got {rank}")
    if rank > d:
        base = np.concatenate(
            [base, np.zeros((rank - d, n), np.float64)], axis=0)
    return base


def nplr_init(measure: str, n: int, rank: int = 1, b_clip: float = 2.0):
    """Full-N DPLR diagonalization of a HiPPO measure (models/s4.py:384-455,
    full-spectrum variant). Returns (Lambda (n,), P (rank, n), B (n,))
    complex128 with A = diag(Lambda) - sum_r P_r P_r^*, in
    [half, conj(half)] order; B's imaginary part clipped to +-b_clip."""
    a, b = hippo_transition(measure, n)
    p = hippo_rank_correction(measure, n, rank)
    ap = a + np.einsum("rm,rn->mn", p, p)
    lam_re = np.mean(np.diagonal(ap)) * np.ones(n)
    lam_im, v = np.linalg.eigh(ap * -1j)
    lam_im, v = _conj_pair_basis(lam_im, v)
    lam = lam_re + 1j * lam_im
    b_rot = v.conj().T @ b.astype(np.complex128)
    p_rot = np.einsum("mn,rm->rn", np.conj(v), p.astype(np.complex128))
    if b_clip is not None:
        b_rot = b_rot.real + 1j * np.clip(b_rot.imag, -b_clip, b_clip)
    return lam, p_rot, b_rot


DIAG_INITS = ("lin", "inv", "legs")
MEASURE_COMBINATIONS = {"hippo": ("legs", "fourier")}


def diag_ssm_init(init: str, n_half: int):
    """Diagonal SSM initialization families: 'lin' (S4D-Lin), 'inv'
    (S4D-Inv), 'legs' (S4D-LegS, the diagonal of the legs NPLR with the
    rotated HiPPO B). Returns (neg_real (n,), imag (n,), B (n,) complex128)
    in the positive-imag convention."""
    big_n = 2 * n_half
    n = np.arange(n_half, dtype=np.float64)
    if init in ("lin", "linear"):
        return 0.5 * np.ones(n_half), np.pi * n, np.ones(n_half, complex)
    if init in ("inv", "inverse"):
        imag = (big_n / np.pi) * (big_n / (1.0 + 2.0 * n) - 1.0)
        return 0.5 * np.ones(n_half), imag, np.ones(n_half, complex)
    if init == "legs":
        lam, _, b = nplr_init("legs", big_n)
        order = np.argsort(lam.imag)[:n_half]  # negative-imag half
        return -lam.real[order], -lam.imag[order], np.conj(b[order])
    raise ValueError(f"unknown diag init {init!r}; one of {DIAG_INITS}")


def s4d_lin_init(h: int, n_half: int):
    """S4D-Lin: Lambda_n = -1/2 + i pi n (models/s4d.py:48-51). Returns
    (log_A_real (h, n_half), A_imag (h, n_half)) float32."""
    log_a_real = np.log(0.5 * np.ones((h, n_half), dtype=np.float32))
    a_imag = np.pi * np.broadcast_to(
        np.arange(n_half, dtype=np.float32), (h, n_half)).copy()
    return log_a_real, a_imag


# ---------------------------------------------------------------------------
# Kernel computations (complex64)
# ---------------------------------------------------------------------------

def _dt_cols(log_dt, dt):
    """The timestep as an (H, 1) or (H, N) column array: exp(log_dt), or an
    explicit dt of shape (H,) or (H, N)."""
    d = torch.exp(log_dt) if dt is None else dt
    return d[:, None] if d.ndim == 1 else d


def _positions(L: int, like: torch.Tensor) -> torch.Tensor:
    """0, 1, ..., L-1 in f32 on ``like``'s device (exact for L < 2^24)."""
    return torch.arange(L, dtype=torch.float32, device=like.device)


def s4d_kernel_zoh(C, A, log_dt, L: int, dt=None):
    """S4D convolution kernel, ZOH discretization (models/s4d.py:53-69):
    K = 2 Re sum_n C'_n e^{dtA_n l}, C' = C (e^{dtA} - 1)/A.

    C: (..., H, N) complex; A: (H, N) complex; log_dt: (H,), or dt= of
    shape (H,) or (H, N). Returns (..., H, L) f32."""
    dt = _dt_cols(log_dt, dt)
    dtA = A * dt
    c_scaled = C * (cexp(dtA) - 1.0) / A
    ls = _positions(L, A)
    a = dtA.real[..., None] * ls                       # (H, N, L)
    b = dtA.imag[..., None] * ls
    e = torch.exp(a)
    k = (torch.einsum("...hn,hnl->...hl", c_scaled.real, e * torch.cos(b))
         - torch.einsum("...hn,hnl->...hl", c_scaled.imag, e * torch.sin(b)))
    return 2.0 * k


def s4d_kernel_bilinear(C, A, log_dt, L: int, dt=None):
    """S4D kernel, bilinear discretization (models/s4.py:1117-1189):
    C' = C dt / (1 - dtA/2), dA = (1 + dtA/2)/(1 - dtA/2),
    K = 2 Re sum_n C'_n dA_n^l. Shapes as ``s4d_kernel_zoh``."""
    dt = _dt_cols(log_dt, dt)
    dtA = A * dt
    c_scaled = C * dt / (1.0 - dtA / 2.0)
    log_dA = clog((1.0 + dtA / 2.0) / (1.0 - dtA / 2.0))
    ls = _positions(L, A)
    a = log_dA.real[..., None] * ls
    b = log_dA.imag[..., None] * ls
    e = torch.exp(a)
    k = (torch.einsum("...hn,hnl->...hl", c_scaled.real, e * torch.cos(b))
         - torch.einsum("...hn,hnl->...hl", c_scaled.imag, e * torch.sin(b)))
    return 2.0 * k


def s4d_kernel_dss(C, A, log_dt, L: int, dt=None):
    """S4D kernel, DSS discretization (models/s4.py:1160-1178):
    softmax-normalized exponentials that tolerate positive-real
    eigenvalues; Re, not 2 Re, as the reference. Shapes as
    ``s4d_kernel_zoh``."""
    dt = _dt_cols(log_dt, dt)
    dtA = A * dt
    ls = _positions(L, A)
    pos = A.real > 0
    p = dtA[..., None] * ls                            # (H, N, L)
    p_max = dtA * torch.where(pos, float(L - 1), 0.0)
    p = p - p_max.detach()[..., None]
    s = cexp(p)
    dtA_neg = dtA * (1.0 - 2.0 * pos.float())
    num = cexp(dtA_neg) - 1.0
    den = cexp(dtA_neg * L) - 1.0
    x = den * A
    r = torch.conj_physical(x) / (x * torch.conj_physical(x) + 1e-7)
    c_scaled = C * num * r
    return (torch.einsum("...hn,hnl->...hl", c_scaled.real, s.real)
            - torch.einsum("...hn,hnl->...hl", c_scaled.imag, s.imag))


S4D_KERNELS = {
    "zoh": s4d_kernel_zoh,
    "bilinear": s4d_kernel_bilinear,
    "dss": s4d_kernel_dss,
}


def cauchy(v, omega, lambd):
    """sum_n v_n / (omega_l - lambda_n) -> (..., L). v: (..., N); lambd:
    broadcastable against v; omega: (L,) complex (models/s4.py:159-168
    cauchy_naive)."""
    return torch.sum(v[..., None, :] / (omega[:, None] - lambd[..., None, :]),
                     dim=-1)


def roots_of_unity(L: int, device=None) -> torch.Tensor:
    """omega_l = e^{-2 pi i l / L} in complex64, from the f32 angle
    fl(fl(-2 pi * l) / L) as the JAX package forms it. Built in f32, the
    root at l = L/2 keeps 1 + omega = i * 8.7e-8 (sin of the f32 pi), not
    the ~1e-16 that a float64 angle leaves, so the bilinear transform
    2(1 - omega)/(1 + omega) stays within f32 range."""
    # torch.full, not torch.tensor: no copy from the host, so the plain
    # versions built on it can be captured in a CUDA graph
    ang = (torch.arange(L, dtype=torch.float32, device=device)
           * torch.full((), -2.0 * math.pi, dtype=torch.float32,
                        device=device)) / L
    return torch.complex(torch.cos(ang), torch.sin(ang))


def dplr_kernel(Lambda, P, B, C_tilde, log_dt, L: int, dt=None):
    """S4 DPLR convolution kernel through the bilinear generating function
    at the roots of unity (models/s4.py:1343-1447), with a rank-general
    Woodbury correction.

    Lambda, B, C_tilde: (..., N) complex; P: (..., N) for rank 1 or
    (..., R, N); log_dt, or dt=: broadcastable against Lambda, (..., 1)
    for one step per feature or (..., N) per state. Leading dimensions
    broadcast. Returns real (..., L). C_tilde is the trained parameter.
    dt folds into v and Lambda, as the reference does (s4.py:1382-1390)."""
    step = torch.exp(log_dt) if dt is None else dt
    if P.ndim == Lambda.ndim:
        P = P.unsqueeze(-2)                           # (..., 1, N)
    R, N = P.shape[-2], P.shape[-1]
    batch = torch.broadcast_shapes(Lambda.shape[:-1], B.shape[:-1],
                                   C_tilde.shape[:-1], P.shape[:-2],
                                   step.shape[:-1])
    Lambda = Lambda.expand(*batch, N)
    step = step.expand(*batch, step.shape[-1])
    omega = roots_of_unity(L, Lambda.device)
    z = 2.0 * (1.0 - omega) / (1.0 + omega)
    c = 2.0 / (1.0 + omega)
    # rows a_i in {conj(C~), conj(P_r)}, cols b_j in {B, P_r}
    ct = C_tilde.expand(*batch, N)[..., None, :]
    a = torch.cat([torch.conj_physical(ct),
                   torch.conj_physical(P.expand(*batch, R, N))], dim=-2)
    b = torch.cat([B.expand(*batch, N)[..., None, :],
                   P.expand(*batch, R, N)], dim=-2)   # (..., R+1, N)
    v = a[..., :, None, :] * b[..., None, :, :]       # (..., R+1, R+1, N)
    st = step[..., None, None, :]
    r = cauchy(v * st, z, (Lambda * step)[..., None, None, :])
    if R == 1:
        kf = (r[..., 0, 0, :]
              - r[..., 0, 1, :] * (1.0 / (1.0 + r[..., 1, 1, :]))
              * r[..., 1, 0, :])
    else:
        r11 = r[..., 1:, 1:, :].movedim(-1, -3)       # (..., L, R, R)
        rhs = r[..., 1:, 0, :].movedim(-1, -2)[..., None]  # (..., L, R, 1)
        eye = torch.eye(R, dtype=r.dtype, device=r.device)
        sol = torch.linalg.solve(eye + r11, rhs)[..., 0]   # (..., L, R)
        kf = r[..., 0, 0, :] - torch.einsum("...rl,...lr->...l",
                                            r[..., 0, 1:, :], sol)
    return torch.fft.ifft(c * kf, n=L, dim=-1).real


def fft_causal_conv(x, k):
    """Causal FFT convolution irfft(rfft(x, 2L) * rfft(k, 2L))[:L]
    (models/s4d.py:118-121). x: (..., L) real, k broadcastable."""
    L = x.shape[-1]
    n = 2 * L
    xf = torch.fft.rfft(x, n=n, dim=-1)
    kf = torch.fft.rfft(k, n=n, dim=-1)
    return torch.fft.irfft(xf * kf, n=n, dim=-1)[..., :L]
