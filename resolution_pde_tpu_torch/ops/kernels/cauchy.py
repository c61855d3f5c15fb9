"""The four Cauchy sums of the S4 DPLR kernel: the hand-written CUDA kernel
and its plain versions, and the DPLR kernel built on them.

Counterpart of resolution_pde_tpu/ops/pallas/cauchy.py. ``cauchy_pallas``
computes, on f32 real and imaginary planes,

    k_t[r, l] = sum_n v_t[r, n] / (g[r, l] - Lambda[r, n]),  t = 0..3,

for rows r (kernel channels folded with features). ``dplr_kernel_pallas``
forms g = (2/dt)(1 - omega)/(1 + omega), the four products v and the
Woodbury combination around the sums and ends in ``torch.fft.ifft``, with
the JAX wrapper's formulation: dt stays in g instead of folding into v and
Lambda as the ``jnp`` route (``ops.ssm.dplr_kernel``) does. The kernel is
``csrc/cauchy.cu``, with two entries on one kernel body: ``dplr_at_roots``
(the model's route, through ``dplr_kernel_pallas``) hands it Lambda, P, B,
C~ and log_dt as they are, row r reading Lambda, P, B and log_dt at
r mod H, and the kernel forms v, g and c and the Woodbury combination
itself, so one launch does the JAX wrapper's work up to the inverse FFT;
``cauchy_sums`` (and ``cauchy_pallas``) hands it v, Lambda and g as f32
planes and gets the four sums back as planes.

Forward only, as in the JAX package, which has no backward for this
kernel: both autograd nodes' backward raises, and training takes the
layers' ``kernel_impl='jnp'`` route. The entries run the plain version for
tensors on the CPU and launch the kernel for CUDA tensors; they never fall
back from one to the other.
"""

from __future__ import annotations

import torch

from resolution_pde_tpu_torch.ops.kernels import _build, _cost
from resolution_pde_tpu_torch.ops.ssm import roots_of_unity

# kernel launches in this process (the plain version never counts)
launches = 0


def operations(rows, h, n, L) -> float:
    """The operations ``dplr_at_roots`` needs (an FMA two, a reciprocal,
    exp and sin or cos one each): per (feature, state, position) d,
    |d|^2, its reciprocal and d / |d|^2 (8) and the sums k10, k11 (16),
    which a feature's rows share (v2 = conj(P) B, v3 = conj(P) P); per
    (row, state, position) the sums k00, k01 (16); per (row, position) the
    Woodbury combination (31); per (feature, position) g and c (32); per
    (row, state) v0, v1 (12), per (feature, state) v2, v3 (12)."""
    return (24.0 * h * n * L + 16.0 * rows * n * L + 31.0 * rows * L
            + 32.0 * h * L + 12.0 * (rows + h) * n)

# the most an evaluation of the values at the roots may depart from the
# plain version (``at_roots_departure``): above what the states summed in
# another order or in float64 give (about 1 at most), below what one
# state's C~ off by 2^-10 gives (hundreds); the tests and chip_smoke.py
# take both readings
AT_ROOTS_LIMIT = 4.0


def cauchy_reference(vr, vi, lr, li, gr, gi):
    """Plain PyTorch version: the TPU kernel's arithmetic on whole arrays.
    vr, vi: (4, R, N); lr, li: (R, N); gr, gi: (R, L), all f32 ->
    (outr, outi), each (4, R, L) f32."""
    dr = gr[:, None, :] - lr[:, :, None]             # (R, N, L)
    di = gi[:, None, :] - li[:, :, None]
    inv = 1.0 / (dr * dr + di * di)
    dr = dr * inv
    di = di * inv
    vr3, vi3 = vr[:, :, :, None], vi[:, :, :, None]  # (4, R, N, 1)
    # (vr + i vi) conj(d) / |d|^2 = (vr dr + vi di) + i (vi dr - vr di)
    outr = torch.sum(vr3 * dr + vi3 * di, dim=2)
    outi = torch.sum(vi3 * dr - vr3 * di, dim=2)
    return outr, outi


def _launch(vr, vi, lr, li, gr, gi):
    _, rows, n = vr.shape
    L = gr.shape[1]
    outr = torch.empty((4, rows, L), dtype=torch.float32, device=vr.device)
    outi = torch.empty_like(outr)
    if outr.numel() == 0:
        return outr, outi
    with torch.cuda.device(vr.device):
        err = _build.library().rpde_cauchy(
            vr.data_ptr(), vi.data_ptr(), lr.data_ptr(), li.data_ptr(),
            gr.data_ptr(), gi.data_ptr(), outr.data_ptr(), outi.data_ptr(),
            rows, n, L, torch.cuda.current_stream(vr.device).cuda_stream)
    _build.check(err, "rpde_cauchy")
    return outr, outi


class CauchySums(torch.autograd.Function):
    """The four sums as an autograd node whose backward raises: the JAX
    package has no backward for this kernel, and a gradient that silently
    stopped here would be wrong."""

    @staticmethod
    def forward(ctx, vr, vi, lr, li, gr, gi):
        global launches
        if vr.device.type == "cpu":
            return cauchy_reference(vr, vi, lr, li, gr, gi)
        out = _launch(vr, vi, lr, li, gr, gi)
        launches += 1
        return out

    @staticmethod
    def backward(ctx, gout_r, gout_i):
        raise NotImplementedError(
            "the S4 Cauchy kernel is forward-only: the JAX package has no "
            "backward for it; train through kernel_impl='jnp'")


def cauchy_sums(vr, vi, lr, li, gr, gi):
    """The four Cauchy sums on planes: vr, vi (4, R, N), lr, li (R, N),
    gr, gi (R, L), f32 on one device -> (outr, outi), each (4, R, L)."""
    dev = vr.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"cauchy_sums runs on cpu or cuda, not {dev}")
    planes = [t.to(torch.float32).contiguous()
              for t in (vr, vi, lr, li, gr, gi)]
    vr, vi, lr, li, gr, gi = planes
    if (vr.dim() != 3 or vr.shape[0] != 4 or vi.shape != vr.shape
            or lr.shape != vr.shape[1:] or li.shape != lr.shape
            or gr.dim() != 2 or gr.shape[0] != vr.shape[1]
            or gi.shape != gr.shape or gr.shape[1] < 1
            or any(t.device != dev for t in planes)):
        raise ValueError(
            "cauchy_sums: v planes (4, R, N), Lambda planes (R, N) and g "
            "planes (R, L >= 1) on one device, got "
            f"{[tuple(t.shape) for t in planes]}")
    return CauchySums.apply(*planes)


def cauchy_pallas(v, g, lambd) -> torch.Tensor:
    """v: (4, R, N) complex; g: (R, L) complex; lambd: (R, N) complex.
    Returns (4, R, L) complex64: sum_n v[t, r, n] / (g[r, l] - lambd[r, n])."""
    outr, outi = cauchy_sums(v.real, v.imag, lambd.real, lambd.imag,
                             g.real, g.imag)
    return torch.complex(outr, outi)


def dplr_operands(Lambda, P, B, C_tilde, log_dt, L: int):
    """The JAX wrapper's Cauchy operands: v (4, rows, N) = the products of
    {conj(C~), conj(P)} with {B, P}, g (rows, L) = (2/dt)(1 - omega)/(1 +
    omega) and c (1, L) = 2/(1 + omega), from Lambda, P, B (H, N) complex,
    C_tilde (rows, N) complex with rows = channels x H, and log_dt (H,);
    row r takes Lambda, P, B and log_dt at r mod H. omega comes from the f32
    angle (``ops.ssm.roots_of_unity``), so g stays finite at the root
    l = L/2."""
    h, n = Lambda.shape
    ch = C_tilde.shape[0] // h
    step = torch.exp(log_dt)[:, None]                        # (H, 1)
    omega = roots_of_unity(L, Lambda.device)[None, :]       # (1, L)
    g = (2.0 / step) * ((1.0 - omega) / (1.0 + omega))     # (H, L)
    c = 2.0 / (1.0 + omega)
    a0 = torch.conj_physical(C_tilde).reshape(ch, h, n)
    a1 = torch.conj_physical(P)
    v = torch.stack(torch.broadcast_tensors(a0 * B, a0 * P, a1 * B, a1 * P))
    return (v.reshape(4, ch * h, n), g.expand(ch, h, L).reshape(ch * h, L),
            c)


def dplr_at_roots_reference(Lambda, P, B, C_tilde, log_dt, L: int):
    """Plain PyTorch version of ``dplr_at_roots``: ``dplr_operands``, the
    four sums (``cauchy_reference``) and the Woodbury combination at the
    roots, (rows, L) complex64."""
    h, n = Lambda.shape
    v, g, c = dplr_operands(Lambda, P, B, C_tilde, log_dt, L)
    lam = Lambda.expand(C_tilde.shape[0] // h, h, n).reshape(-1, n)
    outr, outi = cauchy_reference(v.real, v.imag, lam.real, lam.imag,
                                  g.real, g.imag)
    k00, k01, k10, k11 = torch.complex(outr, outi)
    return c * (k00 - k01 * (1.0 / (1.0 + k11)) * k10)


def dplr_at_roots_scale(Lambda, P, B, C_tilde, log_dt, L: int):
    """The scale of f32 rounding in ``dplr_at_roots``'s output, (rows, L)
    f32, to first order: |c| (S0 + (S1 |k10| + |k01| S2) / |1 + k11| +
    |k01 k10| S3 / |1 + k11|^2), where S_t = sum_n |v_t| / |g - Lambda| is
    the sum of the magnitudes of the terms of k_t. Evaluations that differ
    only in rounding (the states summed in another order, say) lie within
    a few times 2^-24 of it from each other; where the Woodbury combination
    cancels, it is far larger than |at_roots|. Arguments as
    ``dplr_at_roots``."""
    h, n = Lambda.shape
    v, g, c = dplr_operands(Lambda, P, B, C_tilde, log_dt, L)
    lam = Lambda.expand(C_tilde.shape[0] // h, h, n).reshape(-1, n)
    s = (v.abs()[..., None]
         / (g[:, None, :] - lam[:, :, None]).abs()).sum(2)  # (4, rows, L)
    outr, outi = cauchy_reference(v.real, v.imag, lam.real, lam.imag,
                                  g.real, g.imag)
    _, k01, k10, k11 = torch.complex(outr, outi).abs()
    den = (1.0 + torch.complex(outr[3], outi[3])).abs()
    return c.abs() * (s[0] + (s[1] * k10 + k01 * s[2]) / den
                      + k01 * k10 * s[3] / den ** 2)


def at_roots_departure(got, ref, scale, rtol: float = 2e-4,
                       atol: float = 2e-5) -> float:
    """How far ``got`` lies from ``ref`` ((rows, L) complex, values at the
    roots) beyond atol + rtol |ref|, on the real and the imaginary parts,
    in units of 2^-24 ``scale`` (``dplr_at_roots_scale``): the largest
    such part. At most 0 where every part is within atol + rtol |ref|."""
    got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    over = (got - ref).abs() - (atol + rtol * ref.abs())
    return float((over / (2.0 ** -24 * scale[..., None])).max())


def _launch_at_roots(Lambda, P, B, C_tilde, log_dt, L: int) -> torch.Tensor:
    h, n = Lambda.shape
    rows = C_tilde.shape[0]
    out = torch.empty((rows, L), dtype=torch.complex64,
                      device=C_tilde.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(C_tilde.device):
        err = _build.library().rpde_dplr_at_roots(
            Lambda.data_ptr(), P.data_ptr(), B.data_ptr(), C_tilde.data_ptr(),
            log_dt.data_ptr(), out.data_ptr(), rows, h, n, L,
            torch.cuda.current_stream(C_tilde.device).cuda_stream)
    _build.check(err, "rpde_dplr_at_roots")
    return out


class DplrAtRoots(torch.autograd.Function):
    """``dplr_at_roots`` as an autograd node whose backward raises, as
    ``CauchySums``'s does."""

    @staticmethod
    def forward(ctx, Lambda, P, B, C_tilde, log_dt, L):
        global launches
        if C_tilde.device.type == "cpu":
            return dplr_at_roots_reference(Lambda, P, B, C_tilde, log_dt, L)
        out = _launch_at_roots(Lambda, P, B, C_tilde, log_dt, L)
        launches += 1
        h, n = Lambda.shape
        _cost.add(operations, C_tilde.shape[0], h, n, L)
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the S4 Cauchy kernel is forward-only: the JAX package has no "
            "backward for it; train through kernel_impl='jnp'")


def dplr_at_roots(Lambda, P, B, C_tilde, log_dt, L: int) -> torch.Tensor:
    """The rank-1 DPLR kernel's generating function at the L roots of
    unity, c (k00 - k01 k10 / (1 + k11)), in one launch of the Cauchy
    kernel: Lambda, P, B (H, N) complex, C_tilde (rows, N) complex with
    rows = channels x H, log_dt (H,); row r reads Lambda, P, B and log_dt
    at r mod H. Returns (rows, L) complex64."""
    dev = C_tilde.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"dplr_at_roots runs on cpu or cuda, not {dev}")
    Lambda, P, B, C_tilde = (t.to(torch.complex64).contiguous()
                             for t in (Lambda, P, B, C_tilde))
    log_dt = log_dt.to(torch.float32).contiguous()
    h, n = Lambda.shape if Lambda.dim() == 2 else (-1, -1)
    if (P.shape != (h, n) or B.shape != (h, n) or C_tilde.dim() != 2
            or C_tilde.shape[1] != n or h < 1 or n < 1
            or C_tilde.shape[0] % h or log_dt.shape != (h,)
            or any(t.device != dev for t in (Lambda, P, B, log_dt))):
        raise ValueError(
            "dplr_at_roots: Lambda, P, B (H, N), C_tilde (channels x H, N) "
            "and log_dt (H,) on one device, got "
            f"{[tuple(t.shape) for t in (Lambda, P, B, C_tilde, log_dt)]}")
    if L < 1:
        raise ValueError(f"dplr_at_roots: L must be >= 1, got {L}")
    return DplrAtRoots.apply(Lambda, P, B, C_tilde, log_dt, int(L))


def dplr_kernel_pallas(Lambda, P, B, C_tilde, log_dt, L: int) -> torch.Tensor:
    """All-row rank-1 DPLR kernel: ``dplr_at_roots`` (one launch of the
    Cauchy kernel) and an inverse FFT. Lambda, P, B (H, N) complex, C_tilde
    (rows, N) complex with rows = channels x H, log_dt (H,) -> (rows, L)
    f32."""
    at_roots = dplr_at_roots(Lambda, P, B, C_tilde, log_dt, L)
    return torch.fft.ifft(at_roots, n=L, dim=-1).real
