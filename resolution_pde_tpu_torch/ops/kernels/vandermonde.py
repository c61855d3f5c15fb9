"""S4D kernel materialization (the log-Vandermonde reduction): the
hand-written CUDA kernel and its plain versions.

Counterpart of resolution_pde_tpu/ops/pallas/vandermonde.py
``s4d_kernel_pallas``. Per row r (a kernel channel folded with a feature)
and position l:

    K[r, l] = 2 sum_n (C'r[r, n] Re e^{dtA[r, n] l}
                       - C'i[r, n] Im e^{dtA[r, n] l})

with dtA = A e^{log_dt} and C' = C (e^{dtA} - 1)/A. The kernel is
``csrc/vandermonde.cu``, with two entries on one kernel body:
``s4d_kernel_pallas`` (the model's route) hands it C, A and log_dt as they
are and the kernel forms dtA and C' itself, row r reading A and log_dt at
r mod H, so one launch does all of the JAX wrapper's work;
``vandermonde`` hands it the f32 planes (ar, ai, cr, ci). Channels fold
into rows: one launch for all channels.

Forward only, as in the JAX package, which has no backward for this
kernel: both autograd nodes' backward raises, and training takes the
layers' ``kernel_impl='jnp'`` route. The entries run the plain version for
tensors on the CPU and launch the kernel for CUDA tensors; they never fall
back from one to the other.
"""

from __future__ import annotations

import torch

from resolution_pde_tpu_torch.ops.kernels import _build, _cost
from resolution_pde_tpu_torch.ops.ssm import cexp

# kernel launches in this process (the plain version never counts)
launches = 0


def operations(rows, h, n, L) -> float:
    """The operations ``s4d_kernel_pallas`` needs (an FMA two, exp, sin and
    cos one each) when the powers e^{dtA l} are factored as a table and
    anchors: per (row, state, position) 2 FMAs (the real part of an anchor
    times a table entry); per (feature, state) the table's 32 powers
    e^{dtA j} (17 each: the exponent with its FMA remainder, exp, sincos
    and the first-order correction), and its L / 32 anchors' powers; per
    (row, state) dtA and C' (27) and C' times each anchor (6); per (row,
    position) the last 2. dtA is a feature's, C' a row's."""
    anchors = -(-L // 32)
    return (4.0 * rows * n * L + 2.0 * rows * L
            + 17.0 * h * n * (32 + anchors)
            + rows * n * (27.0 + 6.0 * anchors))


def vandermonde_reference(ar, ai, cr, ci, L: int) -> torch.Tensor:
    """Plain PyTorch version: the TPU kernel's arithmetic on whole arrays.
    ar, ai, cr, ci: (R, N) f32 -> (R, L) f32."""
    ls = torch.arange(L, dtype=torch.float32, device=ar.device)
    a = ar[:, :, None] * ls                          # (R, N, L)
    b = ai[:, :, None] * ls
    e = torch.exp(a)
    re = e * torch.cos(b)
    im = e * torch.sin(b)
    return 2.0 * (torch.sum(cr[:, :, None] * re, dim=1)
                  - torch.sum(ci[:, :, None] * im, dim=1))


def _launch(ar, ai, cr, ci, L: int) -> torch.Tensor:
    rows, n = ar.shape
    out = torch.empty((rows, L), dtype=torch.float32, device=ar.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(ar.device):
        err = _build.library().rpde_vandermonde(
            ar.data_ptr(), ai.data_ptr(), cr.data_ptr(), ci.data_ptr(),
            out.data_ptr(), rows, n, L,
            torch.cuda.current_stream(ar.device).cuda_stream)
    _build.check(err, "rpde_vandermonde")
    return out


class Vandermonde(torch.autograd.Function):
    """The reduction as an autograd node whose backward raises: the JAX
    package has no backward for this kernel, and a gradient that silently
    stopped here would be wrong."""

    @staticmethod
    def forward(ctx, ar, ai, cr, ci, L):
        global launches
        if ar.device.type == "cpu":
            return vandermonde_reference(ar, ai, cr, ci, L)
        out = _launch(ar, ai, cr, ci, L)
        launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the S4D Vandermonde kernel is forward-only: the JAX package "
            "has no backward for it; train through kernel_impl='jnp'")


def vandermonde(ar, ai, cr, ci, L: int) -> torch.Tensor:
    """K[r, l] = 2 sum_n (cr e^{ar l} cos(ai l) - ci e^{ar l} sin(ai l)).
    ar, ai, cr, ci: (R, N) f32 planes on one device -> (R, L) f32."""
    dev = ar.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"vandermonde runs on cpu or cuda, not {dev}")
    planes = [t.to(torch.float32).contiguous() for t in (ar, ai, cr, ci)]
    if any(t.shape != ar.shape or t.device != dev for t in planes) \
            or ar.dim() != 2:
        raise ValueError("vandermonde: ar, ai, cr, ci must be (R, N) "
                         f"tensors on one device, got "
                         f"{[tuple(t.shape) for t in (ar, ai, cr, ci)]}")
    if L < 1:
        raise ValueError(f"vandermonde: L must be >= 1, got {L}")
    return Vandermonde.apply(*planes, int(L))


def s4d_operands(C, A, log_dt):
    """The reduction's f32 planes (ar, ai, cr, ci), each (rows, N), from
    C: (H, N) or (CH, H, N) complex, A: (H, N) complex, log_dt: (H,):
    dtA = A e^{log_dt} and C' = C (e^{dtA} - 1)/A, a multi-channel C's
    channels folded into the rows."""
    h, n = C.shape[-2:]
    dtA = A * torch.exp(log_dt)[:, None]
    c_scaled = C * (cexp(dtA) - 1.0) / A         # broadcasts over channels
    rows = C.numel() // n
    return (dtA.real.expand(rows // h, h, n).reshape(rows, n),
            dtA.imag.expand(rows // h, h, n).reshape(rows, n),
            c_scaled.real.reshape(rows, n), c_scaled.imag.reshape(rows, n))


def s4d_kernel_reference(C, A, log_dt, L: int) -> torch.Tensor:
    """Plain PyTorch version of ``s4d_kernel_pallas``: ``s4d_operands``,
    then ``vandermonde_reference``. Returns (H, L) / (CH, H, L) f32."""
    out = vandermonde_reference(*s4d_operands(C, A, log_dt), L)
    return out.reshape(*C.shape[:-1], L)


def _launch_fused(C, A, log_dt, L: int) -> torch.Tensor:
    h, n = A.shape
    rows = C.numel() // n
    out = torch.empty((*C.shape[:-1], L), dtype=torch.float32,
                      device=C.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(C.device):
        err = _build.library().rpde_s4d_kernel(
            C.data_ptr(), A.data_ptr(), log_dt.data_ptr(), out.data_ptr(),
            rows, h, n, L, torch.cuda.current_stream(C.device).cuda_stream)
    _build.check(err, "rpde_s4d_kernel")
    return out


class S4DKernel(torch.autograd.Function):
    """``s4d_kernel_pallas`` as an autograd node whose backward raises, as
    ``Vandermonde``'s does."""

    @staticmethod
    def forward(ctx, C, A, log_dt, L):
        global launches
        if C.device.type == "cpu":
            return s4d_kernel_reference(C, A, log_dt, L)
        out = _launch_fused(C, A, log_dt, L)
        launches += 1
        h, n = A.shape
        _cost.add(operations, C.numel() // n, h, n, L)
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the S4D Vandermonde kernel is forward-only: the JAX package "
            "has no backward for it; train through kernel_impl='jnp'")


def s4d_kernel_pallas(C, A, log_dt, L: int) -> torch.Tensor:
    """The S4D ZOH kernel in one launch of the reduction kernel (the JAX
    wrapper's semantics). C: (H, N) or (CH, H, N) complex; A: (H, N)
    complex; log_dt: (H,). Returns (H, L) / (CH, H, L) f32; a
    multi-channel C folds its channels into the rows, which read A and
    log_dt at row mod H."""
    dev = C.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"s4d_kernel_pallas runs on cpu or cuda, not {dev}")
    C = C.to(torch.complex64).contiguous()
    A = A.to(torch.complex64).contiguous()
    log_dt = log_dt.to(torch.float32).contiguous()
    h, n = A.shape if A.dim() == 2 else (-1, -1)
    if (C.dim() not in (2, 3) or C.shape[-2:] != (h, n)
            or log_dt.shape != (h,) or n < 1
            or A.device != dev or log_dt.device != dev):
        raise ValueError(
            "s4d_kernel_pallas: C (H, N) or (CH, H, N), A (H, N) and "
            "log_dt (H,) on one device, got "
            f"{[tuple(t.shape) for t in (C, A, log_dt)]}")
    if L < 1:
        raise ValueError(f"s4d_kernel_pallas: L must be >= 1, got {L}")
    return S4DKernel.apply(C, A, log_dt, int(L))
