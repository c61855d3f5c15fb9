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

``spectral_axis_pass`` runs the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor; it never falls back from one to the
other. The adjoint and the weight gradient (training) are not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from resolution_pde_tpu_torch.ops.kernels import _build
from resolution_pde_tpu_torch.ops.spectral import _dft_matrices

# number of kernel launches in this process (the plain version never counts)
launches = 0

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


def spectral_axis_pass(x, f2, i2, wpk, axis: int, compute_dtype, acc=None):
    """One axis pass over a channels-last (B, H, W, C) tensor along ``axis``
    (1 = H, 2 = W). Returns (B, H, W, O) in x's dtype; with ``acc`` given,
    adds the pass (rounded to x's dtype) into ``acc`` in place and returns
    it, as the two passes of a factorized conv are summed."""
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (H) or 2 (W), got {axis}")
    if x.device.type == "cpu":
        xr = x if axis == 2 else x.transpose(1, 2)
        lead, n = xr.shape[:2], xr.shape[2]
        y = spectral_pass_reference(xr.reshape(-1, n, x.shape[3]), f2, i2,
                                    wpk, compute_dtype)
        y = y.reshape(*lead, n, -1)
        if axis == 1:
            y = y.transpose(1, 2)
        return acc.add_(y) if acc is not None else y.contiguous()
    if x.device.type != "cuda":
        raise ValueError(f"spectral_axis_pass runs on cpu or cuda, not "
                         f"{x.device}")
    return _launch(x, f2, i2, wpk, axis, compute_dtype, acc)


def _launch(x, f2, i2, wpk, axis, cd, acc):
    global launches
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
    f2c = f2.detach().to(cd).contiguous()
    i2c = i2.detach().to(cd).contiguous()
    wpkc = wpk.detach().to(cd).contiguous()
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
    launches += 1
    return out


def factorized_spectral_conv_2d_pallas2(x, weight_y, weight_x, n_modes: int,
                                        fft_norm: str = "ortho",
                                        compute_dtype=torch.bfloat16):
    """Both FFNO axis passes through the fused kernel: ``weight_y`` along W
    (the last spatial axis) and ``weight_x`` along H, summed in x's dtype.
    x: (B, H, W, C) channels-last -> (B, H, W, C). ``compute_dtype`` None
    computes in x's dtype."""
    _, h, w, _ = x.shape
    cd = compute_dtype if compute_dtype is not None else x.dtype
    m_y = min(n_modes, w // 2 + 1)
    m_x = min(n_modes, h // 2 + 1)
    f2y, i2y = packed_factors(w, m_y, fft_norm, x.device)
    out = spectral_axis_pass(x, f2y, i2y, pack_mix_weight(weight_y, m_y),
                             axis=2, compute_dtype=cd)
    f2x, i2x = packed_factors(h, m_x, fft_norm, x.device)
    return spectral_axis_pass(x, f2x, i2x, pack_mix_weight(weight_x, m_x),
                              axis=1, compute_dtype=cd, acc=out)
