"""Fused FFNO axis pass: the hand-written CUDA kernel and its plain version.

Counterpart of resolution_pde_tpu/ops/pallas/spectral_mix2.py (packed
re/im, bf16 or f32) and, as its f32 mode, of ops/pallas/spectral_mix.py
(forward only). Per row along one axis of n points: the truncated forward
DFT ``(C, n) @ (n, 2m)``, the per-mode complex channel mix
``(2C) @ (2C, 2O)`` with the packed weight of ``pack_mix_weight``, and the
zero-padded inverse DFT ``(O, 2m) @ (2m, n)``; products in
``compute_dtype`` accumulated in f32, each intermediate rounded to
``compute_dtype``, the output in x's dtype. The kernel is
``csrc/spectral_mix.cu``; it reads both axes of a channels-last
(B, H, W, C) tensor in place.

The op is linear in x, so its adjoint is the same pass with transposed
factors (f2' = i2^T, i2' = f2^T, each mode's weight transposed), launched
through the same kernel (``spectral_axis_adjoint``); the packed weight's
gradient is two DFT products and a batched contraction, left to torch
matmuls as the JAX package leaves it to XLA. ``SpectralConv2d`` wires both
into one ``torch.autograd.Function`` around the two-axis conv.

``spectral_axis_pass`` and ``spectral_axis_adjoint`` run the plain version
for a tensor on the CPU and launch the kernel for a CUDA tensor; they never
fall back from one to the other.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from resolution_pde_tpu_torch.ops.kernels import _build
from resolution_pde_tpu_torch.ops.spectral import _dft_matrices

# kernel launches in this process (the plain versions never count)
launches = 0          # forward passes
adjoint_launches = 0  # adjoint passes (the same kernel, transposed factors)

_DTYPES = (torch.float32, torch.bfloat16)


def pack_mix_weight(weight: torch.Tensor, m: int) -> torch.Tensor:
    """(C, O, n_modes, 2) real weight -> (m, 2C, 2O) packed real mix matrix:
    the complex product as blocks [[wr, wi], [-wi, wr]], K rows ordered
    (s, c) and N columns ordered (t, o)."""
    wr, wi = weight[:, :, :m, 0], weight[:, :, :m, 1]
    w5 = torch.stack([torch.stack([wr, wi], dim=2),
                      torch.stack([-wi, wr], dim=2)], dim=2)  # (C,O,s,t,m)
    c, o = weight.shape[0], weight.shape[1]
    return w5.permute(4, 2, 0, 3, 1).reshape(m, 2 * c, 2 * o)


@functools.lru_cache(maxsize=64)
def packed_factors(n: int, m: int, norm: str, device: torch.device):
    """f32 packed DFT factors on ``device``: f2 (n, 2m) with columns (s, m)
    and i2 (2m, n) with rows (t, m). Shared between callers, so read-only."""
    fc, fs, ic, is_ = _dft_matrices(n, m, norm)
    return (torch.from_numpy(np.concatenate([fc, fs], axis=1)).to(device),
            torch.from_numpy(np.concatenate([ic, is_], axis=0)).to(device))


@functools.lru_cache(maxsize=64)
def adjoint_factors(n: int, m: int, norm: str, device: torch.device):
    """The adjoint's factors: i2^T (n, 2m) in f2's place and f2^T (2m, n)
    in i2's, contiguous. Shared between callers, so read-only."""
    f2, i2 = packed_factors(n, m, norm, device)
    return i2.t().contiguous(), f2.t().contiguous()


def spectral_pass_reference(x, f2, i2, wpk, compute_dtype):
    """Plain PyTorch version of one axis pass. x (R, n, C) -> (R, n, O) in
    x's dtype. Products take their inputs rounded to ``compute_dtype`` and
    multiply them in f32, which is exact for bf16 inputs."""
    cd = compute_dtype
    r, n, c = x.shape
    m = wpk.shape[0]
    o = wpk.shape[2] // 2
    xt = x.transpose(1, 2).reshape(r * c, n).to(cd).float()
    z = xt @ f2.to(cd).float()                            # (R*C, 2m)
    zre = z[:, :m].reshape(r, c, m).permute(2, 0, 1)
    zim = z[:, m:].reshape(r, c, m).permute(2, 0, 1)
    zk = torch.cat([zre, zim], dim=-1)                    # (m, R, 2C)
    mixed = torch.bmm(zk.to(cd).float(), wpk.to(cd).float())  # (m, R, 2O)
    mre = mixed[:, :, :o].permute(1, 2, 0).reshape(r * o, m)
    mim = mixed[:, :, o:].permute(1, 2, 0).reshape(r * o, m)
    mk = torch.cat([mre, mim], dim=-1)                    # (R*O, 2m)
    y = mk.to(cd).float() @ i2.to(cd).float()
    return y.reshape(r, o, n).transpose(1, 2).to(x.dtype)


def spectral_adjoint_reference(g, f2t, i2t, wpk, compute_dtype):
    """Plain PyTorch version of one axis pass's adjoint: g (R, n, O) -> dx
    (R, n, C) in g's dtype, with (f2t, i2t) = (i2^T, f2^T) the pass's
    factors swapped and transposed (``adjoint_factors``) and each mode's
    weight transposed: the pass itself, as the JAX package's VJP calls its
    kernel, with the same rounding points."""
    return spectral_pass_reference(g, f2t, i2t, wpk.transpose(1, 2),
                                   compute_dtype)


def _plain_axis_pass(x, f2, i2, wpk, axis, cd, acc):
    xr = x if axis == 2 else x.transpose(1, 2)
    lead, n = xr.shape[:2], xr.shape[2]
    y = spectral_pass_reference(xr.reshape(-1, n, x.shape[3]), f2, i2, wpk,
                                cd)
    y = y.reshape(*lead, n, -1)
    if axis == 1:
        y = y.transpose(1, 2)
    return acc.add_(y) if acc is not None else y.contiguous()


def spectral_axis_pass(x, f2, i2, wpk, axis: int, compute_dtype, acc=None):
    """One axis pass over a channels-last (B, H, W, C) tensor along ``axis``
    (1 = H, 2 = W). Returns (B, H, W, O) in x's dtype; with ``acc`` given,
    adds the pass (rounded to x's dtype) into ``acc`` in place and returns
    it, as the two passes of a factorized conv are summed."""
    global launches
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (H) or 2 (W), got {axis}")
    if x.device.type == "cpu":
        return _plain_axis_pass(x, f2, i2, wpk, axis, compute_dtype, acc)
    if x.device.type != "cuda":
        raise ValueError(f"spectral_axis_pass runs on cpu or cuda, not "
                         f"{x.device}")
    out = _launch(x, f2, i2, wpk, axis, compute_dtype, acc)
    launches += 1
    return out


def spectral_axis_adjoint(g, f2t, i2t, wpk, axis: int, compute_dtype,
                          acc=None):
    """Adjoint of ``spectral_axis_pass`` along ``axis``: g (B, H, W, O) ->
    (B, H, W, C) in g's dtype, added into ``acc`` when it is given.
    (f2t, i2t) are the pass's factors swapped and transposed, i2^T (n, 2m)
    and f2^T (2m, n), as ``adjoint_factors`` caches them; wpk is the pass's
    own packed weight, transposed per mode here. On a CUDA tensor it
    launches the pass kernel with those factors."""
    global adjoint_launches
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (H) or 2 (W), got {axis}")
    wpk_t = wpk.transpose(1, 2)
    if g.device.type == "cpu":
        return _plain_axis_pass(g, f2t, i2t, wpk_t, axis, compute_dtype, acc)
    if g.device.type != "cuda":
        raise ValueError(f"spectral_axis_adjoint runs on cpu or cuda, not "
                         f"{g.device}")
    out = _launch(g, f2t, i2t, wpk_t, axis, compute_dtype, acc)
    adjoint_launches += 1
    return out


@contextlib.contextmanager
def _ieee_f32_matmul():
    """f32 matmuls in IEEE f32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def spectral_weight_grad(x, g, f2, i2, axis: int, compute_dtype):
    """Gradient of one axis pass with respect to its packed weight:
    x (B, H, W, C), g (B, H, W, O) -> dwpk (m, 2C, 2O) in f32.

    As the JAX package's VJP (XLA there, torch matmuls here): the spectra
    z = x^T f2 and gs = g^T i2^T with each factor rounded to its operand's
    dtype, both rounded to ``compute_dtype``, and per mode
    dwpk[k] = z_k^T gs_k over the rows, summed and returned in f32. The
    operands hold values of at most f32 precision and are multiplied in
    IEEE f32 (TF32 off), so a bf16 product is exact and only the order of
    the f32 sums differs from the TPU's."""
    cd = compute_dtype
    m = f2.shape[1] // 2
    xr = x if axis == 2 else x.transpose(1, 2)
    gr = g if axis == 2 else g.transpose(1, 2)
    n, c, o = xr.shape[2], xr.shape[3], gr.shape[3]
    r = xr.shape[0] * xr.shape[1]
    with _ieee_f32_matmul():
        xt = xr.transpose(2, 3).reshape(r * c, n).float()
        z = xt @ f2.to(x.dtype).float()                    # (R*C, 2m)
        z = z.reshape(r, c, 2, m).permute(3, 0, 2, 1).reshape(m, r, 2 * c)
        gt = gr.transpose(2, 3).reshape(r * o, n).float()
        gs = gt @ i2.t().to(g.dtype).float()               # (R*O, 2m)
        gs = gs.reshape(r, o, 2, m).permute(3, 0, 2, 1).reshape(m, r, 2 * o)
        return torch.bmm(z.to(cd).float().transpose(1, 2),
                         gs.to(cd).float())                # (m, 2C, 2O)


def _launch(x, f2, i2, wpk, axis, cd, acc):
    if x.dim() != 4 or x.stride(3) != 1:
        raise ValueError("spectral_axis_pass kernel needs a (B, H, W, C) "
                         "tensor with unit channel stride")
    if cd not in _DTYPES or x.dtype not in _DTYPES:
        raise ValueError(f"spectral_axis_pass kernel takes float32/bfloat16, "
                         f"got x {x.dtype}, compute_dtype {cd}")
    b, h, w, c = x.shape
    n = x.shape[axis]
    m = wpk.shape[0]
    o = wpk.shape[2] // 2
    if (f2.shape != (n, 2 * m) or i2.shape != (2 * m, n)
            or wpk.shape != (m, 2 * c, 2 * o)):
        raise ValueError(f"factor/weight shapes {tuple(f2.shape)}, "
                         f"{tuple(i2.shape)}, {tuple(wpk.shape)} do not fit "
                         f"n={n}, C={c}")
    if any(t.device != x.device for t in (f2, i2, wpk)):
        raise ValueError(f"spectral_axis_pass: all tensors must be on "
                         f"{x.device}")
    out_shape = (b, h, w, o)
    if acc is None:
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    else:
        if (acc.shape != out_shape or acc.dtype != x.dtype
                or not acc.is_contiguous() or acc.device != x.device):
            raise ValueError(f"acc must be a contiguous {out_shape} tensor "
                             f"of x's dtype on {x.device}")
        out = acc
    if out.numel() == 0:
        return out
    f2c = f2.to(cd).contiguous()
    i2c = i2.to(cd).contiguous()
    wpkc = wpk.to(cd).contiguous()
    so = out.stride()
    sx = x.stride()
    if axis == 2:   # rows (b, h), points along w
        rows_lo, xs, ys = h, (sx[0], sx[1], sx[2]), (so[0], so[1], so[2])
    else:           # rows (b, w), points along h
        rows_lo, xs, ys = w, (sx[0], sx[2], sx[1]), (so[0], so[2], so[1])
    with torch.cuda.device(x.device):
        err = _build.library().rpde_spectral_pass(
            int(cd == torch.bfloat16), int(x.dtype == torch.bfloat16),
            x.data_ptr(), f2c.data_ptr(), i2c.data_ptr(), wpkc.data_ptr(),
            out.data_ptr(), n, m, c, o, b * (h * w // n), rows_lo, *xs, *ys,
            int(acc is not None),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rpde_spectral_pass")
    return out


class SpectralConv2d(torch.autograd.Function):
    """Both axis passes of a factorized spectral conv and their backward:
    the W pass, the H pass added into its output in place, and in the
    backward the W pass's adjoint, the H pass's adjoint added into it (g
    read in place along H), and both packed weights' gradients. ``opts``
    is (fft_norm, compute_dtype)."""

    @staticmethod
    def forward(ctx, opts, x, wpk_y, wpk_x):
        norm, cd = opts
        _, h, w, _ = x.shape
        f2y, i2y = packed_factors(w, wpk_y.shape[0], norm, x.device)
        f2x, i2x = packed_factors(h, wpk_x.shape[0], norm, x.device)
        out = spectral_axis_pass(x, f2y, i2y, wpk_y, 2, cd)
        spectral_axis_pass(x, f2x, i2x, wpk_x, 1, cd, acc=out)
        ctx.opts = opts
        ctx.save_for_backward(x, wpk_y, wpk_x)
        return out

    @staticmethod
    def backward(ctx, g):
        norm, cd = ctx.opts
        x, wpk_y, wpk_x = ctx.saved_tensors
        _, h, w, _ = x.shape
        g = g.contiguous()
        my, mx = wpk_y.shape[0], wpk_x.shape[0]
        f2y, i2y = packed_factors(w, my, norm, x.device)
        f2x, i2x = packed_factors(h, mx, norm, x.device)
        dx = dwy = dwx = None
        if ctx.needs_input_grad[1]:
            dx = spectral_axis_adjoint(
                g, *adjoint_factors(w, my, norm, x.device), wpk_y, 2, cd)
            spectral_axis_adjoint(
                g, *adjoint_factors(h, mx, norm, x.device), wpk_x, 1, cd,
                acc=dx)
        if ctx.needs_input_grad[2]:
            dwy = spectral_weight_grad(x, g, f2y, i2y, 2, cd).to(wpk_y.dtype)
        if ctx.needs_input_grad[3]:
            dwx = spectral_weight_grad(x, g, f2x, i2x, 1, cd).to(wpk_x.dtype)
        return None, dx, dwy, dwx


def factorized_spectral_conv_2d_pallas2(x, weight_y, weight_x, n_modes: int,
                                        fft_norm: str = "ortho",
                                        compute_dtype=torch.bfloat16):
    """Both FFNO axis passes through the fused kernel: ``weight_y`` along W
    (the last spatial axis) and ``weight_x`` along H, summed in x's dtype.
    x: (B, H, W, C) channels-last -> (B, H, W, C). ``compute_dtype`` None
    computes in x's dtype. Differentiable through ``SpectralConv2d``; the
    gradient of each packed weight reaches its (C, O, n_modes, 2) weight
    through ``pack_mix_weight``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"factorized_spectral_conv_2d_pallas2 runs on cpu "
                         f"or cuda, not {x.device}")
    _, h, w, _ = x.shape
    cd = compute_dtype if compute_dtype is not None else x.dtype
    wpk_y = pack_mix_weight(weight_y, min(n_modes, w // 2 + 1)).float()
    wpk_x = pack_mix_weight(weight_x, min(n_modes, h // 2 + 1)).float()
    return SpectralConv2d.apply((fft_norm, cd), x, wpk_y, wpk_x)
