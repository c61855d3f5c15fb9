"""The four Cauchy sums of the S4 DPLR kernel: the hand-written CUDA kernel
and its plain version, and the DPLR kernel built on them.

Counterpart of resolution_pde_tpu/ops/pallas/cauchy.py. ``cauchy_pallas``
computes, on f32 real and imaginary planes,

    k_t[r, l] = sum_n v_t[r, n] / (g[r, l] - Lambda[r, n]),  t = 0..3,

for rows r (kernel channels folded with features); the kernel is
``csrc/cauchy.cu``: one thread per (row, l), the row's v and Lambda staged
in shared memory, ragged edges masked, so the JAX wrapper's padding (Lambda
padded with 1.0 to keep padded rows finite) has no counterpart.
``dplr_kernel_pallas`` forms g, the four products v and the Woodbury
combination around it and ends in ``torch.fft.ifft``, with the JAX
wrapper's formulation: dt stays in g = (2/dt)(1 - omega)/(1 + omega)
instead of folding into v and Lambda as the ``jnp`` route
(``ops.ssm.dplr_kernel``) does.

Forward only, as in the JAX package, which has no backward for this
kernel: ``CauchySums.backward`` raises, and training takes the layers'
``kernel_impl='jnp'`` route. ``cauchy_sums`` runs the plain version for a
tensor on the CPU and launches the kernel for a CUDA tensor; it never
falls back from one to the other.
"""

from __future__ import annotations

import torch

from resolution_pde_tpu_torch.ops.kernels import _build
from resolution_pde_tpu_torch.ops.ssm import roots_of_unity

# kernel launches in this process (the plain version never counts)
launches = 0


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
    """The JAX wrapper's Cauchy operands: v (4, R, N) = the products of
    {conj(C~), conj(P)} with {B, P}, g (R, L) = (2/dt)(1 - omega)/(1 + omega)
    and c (1, L) = 2/(1 + omega), from Lambda, P, B, C_tilde (R, N) complex
    and log_dt (R,). omega comes from the f32 angle
    (``ops.ssm.roots_of_unity``), so g stays finite at the root l = L/2."""
    step = torch.exp(log_dt)[:, None]                        # (R, 1)
    omega = roots_of_unity(L, Lambda.device)[None, :]       # (1, L)
    g = (2.0 / step) * ((1.0 - omega) / (1.0 + omega))     # (R, L)
    c = 2.0 / (1.0 + omega)
    a0, a1 = torch.conj_physical(C_tilde), torch.conj_physical(P)
    v = torch.stack([a0 * B, a0 * P, a1 * B, a1 * P])
    return v, g, c


def dplr_kernel_pallas(Lambda, P, B, C_tilde, log_dt, L: int) -> torch.Tensor:
    """All-row rank-1 DPLR kernel with the Cauchy sums in the kernel:
    Lambda, P, B, C_tilde (R, N) complex, log_dt (R,) -> (R, L) f32, the
    Woodbury combination at the roots and an inverse FFT around
    ``cauchy_pallas``."""
    v, g, c = dplr_operands(Lambda, P, B, C_tilde, log_dt, L)
    k00, k01, k10, k11 = cauchy_pallas(v, g, Lambda)
    at_roots = c * (k00 - k01 * (1.0 / (1.0 + k11)) * k10)
    return torch.fft.ifft(at_roots, n=L, dim=-1).real
