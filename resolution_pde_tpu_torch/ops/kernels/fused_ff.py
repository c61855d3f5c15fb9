"""Fused FFNO FeedForward: the hand-written CUDA kernel and its plain version.

Counterpart of resolution_pde_tpu/ops/pallas/fused_ff.py (forward only):
``Dense -> GELU -> ... -> Dense [-> LayerNorm] [+ residual]`` over the
rows of ``x``, with products in ``compute_dtype`` accumulated in f32, bias,
GELU, LayerNorm (eps 1e-5) and residual in f32, each hidden activation
rounded to ``compute_dtype`` and the output in x's dtype. The kernel is
``csrc/fused_ff.cu``.

``fused_feedforward`` runs the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor; it never falls back from one to the
other. The backward kernel (training) is not ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch

from resolution_pde_tpu_torch.ops.kernels import _build

LN_EPS = 1e-5  # torch.nn.LayerNorm default (reference parity)
MAX_LAYERS = 32  # kMaxLayers of csrc/fused_ff.cu
_SQRT_2_OVER_PI = 0.7978845608028654
_INV_SQRT_2 = 0.7071067811865476

# number of kernel launches in this process (the plain version never counts)
launches = 0


def _gelu(z: torch.Tensor, approx: bool) -> torch.Tensor:
    if approx:
        u = _SQRT_2_OVER_PI * (z + 0.044715 * z * z * z)
        return 0.5 * z * (1.0 + torch.tanh(u))
    return 0.5 * z * (1.0 + torch.erf(z * _INV_SQRT_2))


def fused_feedforward_reference(x, kernels, biases, ln=None, residual=None, *,
                                approx_gelu: bool = True,
                                compute_dtype=torch.bfloat16):
    """Plain PyTorch version of the kernel, with its rounding points.

    x: (..., C_in). kernels: (in_i, out_i) matrices; biases: (out_i,);
    ln: optional (scale, bias), each (C_out,); residual: optional
    (..., C_out). Products take their inputs rounded to ``compute_dtype``
    and multiply them in f32, which is exact for bf16 inputs, so the sum is
    the kernel's f32 accumulation up to its order.
    """
    cd = compute_dtype
    c_out = kernels[-1].shape[1]
    h = x.reshape(-1, x.shape[-1]).to(cd)
    z = None
    for i, (k, b) in enumerate(zip(kernels, biases)):
        z = h.float() @ k.to(cd).float() + b.float()
        if i < len(kernels) - 1:
            h = _gelu(z, approx_gelu).to(cd)
    if ln is not None:
        mu = z.mean(dim=-1, keepdim=True)
        zc = z - mu
        var = (zc * zc).mean(dim=-1, keepdim=True)
        z = zc * torch.rsqrt(var + LN_EPS) * ln[0].float() + ln[1].float()
    if residual is not None:
        z = z + residual.reshape(-1, c_out).float()
    return z.to(x.dtype).reshape(*x.shape[:-1], c_out)


_IO_DTYPES = (torch.float32, torch.bfloat16)


def fused_feedforward(x, kernels, biases, ln=None, residual=None, *,
                      approx_gelu: bool = True, compute_dtype=torch.bfloat16,
                      save_acts: bool = False):
    """Fused Dense->GELU->...->Dense[->LayerNorm][+residual] chain.

    Arguments as ``fused_feedforward_reference``. ``save_acts`` stores the
    pre-activations for a backward pass, which is training and not ported:
    it raises.
    """
    if save_acts:
        raise NotImplementedError("save_acts is training-only; the fused "
                                  "FeedForward backward is not ported yet")
    if x.device.type == "cpu":
        return fused_feedforward_reference(
            x, kernels, biases, ln, residual, approx_gelu=approx_gelu,
            compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_feedforward runs on cpu or cuda, not "
                         f"{x.device}")
    return _launch(x, kernels, biases, ln, residual, approx_gelu,
                   compute_dtype)


def _launch(x, kernels, biases, ln, residual, approx_gelu, cd):
    global launches
    if cd not in _IO_DTYPES or x.dtype not in _IO_DTYPES:
        raise ValueError(f"fused_feedforward kernel takes float32/bfloat16, "
                         f"got x {x.dtype}, compute_dtype {cd}")
    if len(kernels) != len(biases) or not 1 <= len(kernels) <= MAX_LAYERS:
        raise ValueError(f"need one bias per kernel and 1 to {MAX_LAYERS} "
                         f"layers, got {len(kernels)} and {len(biases)}")
    dims = [x.shape[-1]]
    for k, b in zip(kernels, biases):
        if k.dim() != 2 or k.shape[0] != dims[-1] or b.shape != (k.shape[1],):
            raise ValueError(f"layer shapes do not chain: kernel "
                             f"{tuple(k.shape)}, bias {tuple(b.shape)} after "
                             f"width {dims[-1]}")
        dims.append(k.shape[1])
    c_out = dims[-1]
    if not x.is_contiguous():
        raise ValueError("fused_feedforward kernel needs a contiguous x")
    n = math.prod(x.shape[:-1])
    tensors = [x, *kernels, *biases]
    if residual is not None:
        if residual.shape != (*x.shape[:-1], c_out):
            raise ValueError(f"residual shape {tuple(residual.shape)} != "
                             f"{(*x.shape[:-1], c_out)}")
        if residual.dtype != x.dtype or not residual.is_contiguous():
            raise ValueError("fused_feedforward kernel needs a contiguous "
                             "residual of x's dtype")
        tensors.append(residual)
    if ln is not None:
        if any(t.shape != (c_out,) for t in ln):
            raise ValueError(f"LayerNorm parameters must be ({c_out},)")
        tensors += list(ln)
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_feedforward: all tensors must be on "
                         f"{x.device}")

    out = torch.empty((*x.shape[:-1], c_out), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    w = torch.cat([k.detach().to(cd).reshape(-1) for k in kernels])
    b = torch.cat([t.detach().float().reshape(-1) for t in biases])
    ln_s = ln_b = None
    if ln is not None:
        ln_s = ln[0].detach().float().contiguous()
        ln_b = ln[1].detach().float().contiguous()
    c_dims = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(x.device):
        err = _build.library().rpde_fused_ff_forward(
            int(cd == torch.bfloat16), int(x.dtype == torch.bfloat16),
            x.data_ptr(), residual.data_ptr() if residual is not None else None,
            out.data_ptr(), w.data_ptr(), b.data_ptr(),
            ln_s.data_ptr() if ln_s is not None else None,
            ln_b.data_ptr() if ln_b is not None else None,
            c_dims, len(kernels), n, int(bool(approx_gelu)),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rpde_fused_ff_forward")
    launches += 1
    return out
