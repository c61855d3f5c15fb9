"""FFNO axis pass: the hand-written CUDA kernels and their plain version.

Counterpart of resolution_pde_tpu/ops/pallas/spectral_mix2.py (packed
re/im, bf16 or f32) and, as its f32 mode, of ops/pallas/spectral_mix.py
(forward only). Per row along one axis of n points: the truncated forward
DFT ``(C, n) @ (n, 2m)``, the per-mode complex channel mix
``(2C) @ (2C, 2O)`` with the packed weight [[a, b], [-b, a]], and the
zero-padded inverse DFT ``(O, 2m) @ (2m, n)``; products in
``compute_dtype`` accumulated in f32, each intermediate rounded to
``compute_dtype``, the output in x's dtype. Both kernels read both axes of
a channels-last (B, H, W, C) tensor in place.

The entry points take the mix weight as its blocks, (m, 2, C, O) = a | b
per mode, the real and imaginary parts of a complex weight
(``mix_blocks``), and not as a packed (m, 2C, 2O) matrix: the mix is a
complex product, and the kernels read only a and b and make -b
themselves, so a packed matrix of any other form could not be told to
them. The plain version multiplies by the packed form (``pack_blocks``),
as the TPU kernel does. In bf16 every pass runs on the staged route,
``csrc/spectral_staged.cu``: three tensor-core products with the spectra
and the mixed spectra in device memory in bf16, on the factors transposed
and padded to whole tiles (``staged_factors``, cached by shape) and each
mode's blocks padded to 8 channels (``staged_weight``, once per launch);
``staged_pass_plain`` is the same three stages written plainly on those
operands. In f32 (the f32-exact mode) the kernel is
``csrc/spectral_mix.cu``: IEEE f32 FMAs on the CUDA cores, on the factors
zero-padded to its tiles (``kernel_factors_f32``, cached by shape) and
each mode's blocks padded to 8 channels (``kernel_weight_f32``, once per
launch); an f32 pass beyond its tile (more than 64 modes, or more than 256
channels in or out) runs as its launches over chunks of modes and channels
(``f32_chunk_plan``). ``spectral_route`` picks the route from the shape
alone; what no route takes raises a ValueError before any launch.

The op is linear in x, so its adjoint is the same pass with transposed
factors (f2' = i2^T, i2' = f2^T) and each mode's weight conjugated and
transposed (``adjoint_blocks``), launched through the same kernels
(``spectral_axis_adjoint``). The weight's gradient is two DFT products and
a per-mode contraction over the rows (``spectral_weight_grad``), which the
JAX package leaves to XLA: in bf16 it runs on kernels of the staged route
(stage 1 for both spectra, then the per-mode product), elsewhere as the
plain torch products (``weight_grad_plain``). ``SpectralConv2d`` wires both
into one
``torch.autograd.Function`` around the two-axis conv; ``SpectralAxis`` is
one axis pass and its backward, from which
``factorized_spectral_conv_2d_pallas2_slabs`` builds the conv on the
slabs of a grid sharded over "spatial" (the W pass on the slab, the H
pass on pencils, parallel/spatial.py).

``spectral_axis_pass`` and ``spectral_axis_adjoint`` run the plain version
for a tensor on the CPU and launch a kernel for a CUDA tensor; they never
fall back from one to the other.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from resolution_pde_tpu_torch.ops.kernels import _build, _cost
from resolution_pde_tpu_torch.ops.spectral import _dft_matrices
from resolution_pde_tpu_torch.parallel import spatial
from resolution_pde_tpu_torch.utils.tracing import span

# kernel launches in this process (the plain versions never count)
launches = 0          # forward passes
adjoint_launches = 0  # adjoint passes (the same kernel, transposed factors)
wide_launches = 0     # of those, bf16 passes and adjoints (the staged route)
k3_launches = 0       # launches of the f32 kernel, one a chunk of a pass
wgrad_launches = 0    # bf16 weight gradients on the staged route's kernels

_DTYPES = (torch.float32, torch.bfloat16)


def mix_blocks(weight: torch.Tensor, m: int) -> torch.Tensor:
    """(C, O, n_modes, 2) real weight -> (m, 2, C, O), a view: for each of
    the first m modes the blocks a = Re W_k and b = Im W_k of its complex
    (C, O) mix weight, as the axis passes take it."""
    return weight[:, :, :m].permute(2, 3, 0, 1)


def pack_blocks(wab: torch.Tensor) -> torch.Tensor:
    """(m, 2, C, O) blocks a | b -> (m, 2C, 2O) packed real mix matrix:
    the complex product as blocks [[a, b], [-b, a]], K rows ordered (s, c)
    and N columns ordered (t, o)."""
    a, b = wab[:, 0], wab[:, 1]
    return torch.cat([torch.cat([a, b], dim=2), torch.cat([-b, a], dim=2)],
                     dim=1)


def pack_mix_weight(weight: torch.Tensor, m: int) -> torch.Tensor:
    """(C, O, n_modes, 2) real weight -> (m, 2C, 2O) packed real mix
    matrix, as the JAX package's ``pack_mix_weight``."""
    return pack_blocks(mix_blocks(weight, m))


def dft_flops(n, m) -> float:
    """The operations one truncated DFT of n points to m modes (or its
    zero-padded inverse) needs: the cheaper of a real FFT, 2.5 n log2 n
    (FFTW's count for real data), and the dense product of n points by 2m
    packed modes, 4 n m."""
    return min(2.5 * n * math.log2(n), 4.0 * n * m)


def pass_cost(rows, n, c, o, m, io, cd, acc=False) -> tuple:
    """(operations, bytes) of one axis pass (forward or adjoint) of
    ``rows`` rows of n points, c channels in and o out. Operations: what
    the function needs, each channel's forward and inverse DFT as
    ``dft_flops`` counts it and the mix's complex product, 8 c o real
    operations a mode (the kernels compute the DFTs as dense products
    instead, 4 n m a channel). Bytes: x and out in ``io`` (out read too
    with ``acc``), the two factors and the weight's blocks a | b in
    ``cd``."""
    e, ec = (torch.finfo(t).bits // 8 for t in (io, cd))
    ops = rows * ((c + o) * dft_flops(n, m) + 8.0 * m * c * o)
    nbytes = (rows * n * (c + o * (2 if acc else 1)) * e
              + (2 * n * 2 * m + m * 2 * c * o) * ec)
    return ops, nbytes


def adjoint_blocks(wab: torch.Tensor) -> torch.Tensor:
    """(m, 2, C, O) blocks of a pass -> (m, 2, O, C) blocks of its adjoint:
    each mode's weight conjugated and transposed, a^T | -b^T, whose packed
    form is the pass's packed matrix transposed per mode."""
    return torch.stack([wab[:, 0].transpose(1, 2),
                        -wab[:, 1].transpose(1, 2)], dim=1)


def _blocks_grad(dwpk: torch.Tensor) -> torch.Tensor:
    """The gradient of ``pack_blocks``: d(m, 2C, 2O) -> d(m, 2, C, O)."""
    c, o = dwpk.shape[1] // 2, dwpk.shape[2] // 2
    return torch.stack([dwpk[:, :c, :o] + dwpk[:, c:, o:],
                        dwpk[:, :c, o:] - dwpk[:, c:, :o]], dim=1)


# The factor caches are unbounded: a captured CUDA graph (deploy/serving.py)
# reads these tensors by address, so none may be evicted and freed. Their
# keys are the shapes a process serves and trains.
@functools.cache
def packed_factors(n: int, m: int, norm: str, device: torch.device):
    """f32 packed DFT factors on ``device``: f2 (n, 2m) with columns (s, m)
    and i2 (2m, n) with rows (t, m). Shared between callers, so read-only."""
    fc, fs, ic, is_ = _dft_matrices(n, m, norm)
    return (torch.from_numpy(np.concatenate([fc, fs], axis=1)).to(device),
            torch.from_numpy(np.concatenate([ic, is_], axis=0)).to(device))


@functools.cache
def adjoint_factors(n: int, m: int, norm: str, device: torch.device):
    """The adjoint's factors: i2^T (n, 2m) in f2's place and f2^T (2m, n)
    in i2's, contiguous. Shared between callers, so read-only."""
    f2, i2 = packed_factors(n, m, norm, device)
    return i2.t().contiguous(), f2.t().contiguous()


# the f32 kernel's tiles (csrc/spectral_mix.cu): a block product's rows
# (packed modes of the forward, points of the inverse), the forward's
# contraction slice (points), the most channels a tile's columns hold (a
# tile of one row) and the most modes its spectra's shared memory holds
_F32_TILE_M = 128
_F32_K1 = 32
_F32_MAX_CHANNELS = 256
_F32_MAX_MODES = 64


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


def mode_factors(f2, i2, k0: int, k1: int) -> tuple:
    """The packed factors of modes k0 .. k1 - 1 of an m-mode pass: f2's
    columns (s, k) and i2's rows (s, k) for those k, both parts; the pass
    is a sum over its modes, so it is the sum of such passes."""
    m = f2.shape[1] // 2
    cols = list(range(k0, k1)) + list(range(m + k0, m + k1))
    return f2[:, cols], i2[cols]


@functools.cache
def kernel_factors_f32(n: int, m: int, norm: str, device: torch.device,
                       adjoint: bool = False, k0: int = 0, k1=None):
    """The f32 kernel's DFT factors for a pass, or with ``adjoint`` for its
    adjoint, of modes k0 .. k1 - 1 (all m by default, ``mode_factors``):
    f2 (n, 2m') of ``packed_factors`` (of ``adjoint_factors``) zero-padded
    to (n rounded up to 32, 2m' rounded up to 128) and i2 (2m', n)
    zero-padded to (2m' rounded up to 128, n rounded up to 128), both f32,
    contiguous and row-major, so that every slice the kernel copies is
    whole and its inner loops need no bounds. Shared between callers, so
    read-only."""
    f2, i2 = (adjoint_factors if adjoint else packed_factors)(n, m, norm,
                                                              device)
    k1 = m if k1 is None else k1
    if (k0, k1) != (0, m):
        f2, i2 = mode_factors(f2, i2, k0, k1)
    sr = _round_up(2 * (k1 - k0), _F32_TILE_M)
    f2p = torch.zeros((_round_up(n, _F32_K1), sr), dtype=torch.float32,
                      device=device)
    f2p[:n, :f2.shape[1]] = f2
    i2p = torch.zeros((sr, _round_up(n, _F32_TILE_M)), dtype=torch.float32,
                      device=device)
    i2p[:i2.shape[0], :n] = i2
    return f2p, i2p


def kernel_weight_f32(wab: torch.Tensor) -> torch.Tensor:
    """(m, 2, C, O) blocks a | b -> the f32 kernel's (m, 2, C8, O8): C and
    O rounded up to 8 with zeros in the padding, in f32. The kernel makes
    the packed form's -b itself."""
    m, _, c, o = wab.shape
    c8, o8 = _round_up(c, 8), _round_up(o, 8)
    make = torch.empty if (c, o) == (c8, o8) else torch.zeros
    out = make((m, 2, c8, o8), dtype=torch.float32, device=wab.device)
    out[:, :, :c, :o] = wab
    return out


def _check_f32_shape(m: int, c: int, o: int) -> None:
    """One launch of the f32 kernel takes at most 256 channels in and out
    (after padding to 8; a tile of 4 rows up to 64, of 2 up to 128, of 1
    up to 256) and 64 modes (its spectra, 2m padded to 128 rows, stay in
    shared memory); ``f32_chunk_plan`` keeps every launch within them."""
    if (max(_round_up(c, 8), _round_up(o, 8)) > _F32_MAX_CHANNELS
            or m > _F32_MAX_MODES):
        raise ValueError(
            f"spectral_axis_pass f32: one launch of the CUDA-core kernel "
            f"takes at most {_F32_MAX_CHANNELS} channels and "
            f"{_F32_MAX_MODES} modes, got C={c}, O={o}, m={m}")


def f32_chunk_plan(m: int, c: int, o: int) -> list:
    """The f32 kernel's launches for a pass of m modes, c channels in and o
    out, in launch order: (k0, k1, c0, c1, o0, o1) for modes k0 .. k1 - 1,
    input channels c0 .. c1 - 1 and output channels o0 .. o1 - 1, at most
    64 modes and 256 channels each. The pass is linear in its modes and
    input channels and its output channels are independent, so each output
    slice is the sum of its chunks: the first writes it (or adds into the
    caller's acc), the later ones add. One launch where the shape fits; the
    order is fixed by the shape, so two calls give the same bits."""
    return [(k0, min(k0 + _F32_MAX_MODES, m), c0,
             min(c0 + _F32_MAX_CHANNELS, c), o0,
             min(o0 + _F32_MAX_CHANNELS, o))
            for o0 in range(0, o, _F32_MAX_CHANNELS)
            for k0 in range(0, m, _F32_MAX_MODES)
            for c0 in range(0, c, _F32_MAX_CHANNELS)]


# The staged route (csrc/spectral_staged.cu): its operands are padded for
# block tiles of up to 128 rows and columns and a contraction slice of up
# to 64; the most modes it takes.
_STAGED_TILE, _STAGED_K = 128, 64
_STAGED_MAX_MODES = 65535


def staged_fits(n: int, m: int, c: int, o: int) -> bool:
    """Whether the staged route takes a pass of n points, m modes, c
    channels in and o out (a mirror of ``staged_fits``,
    csrc/spectral_staged.cu): its grids and every offset inside a padded
    factor or a mode of the weight's blocks fit their types."""
    if min(n, m, c, o) < 1 or m > _STAGED_MAX_MODES:
        return False
    c8, o8 = _round_up(c, 8), _round_up(o, 8)
    return (_round_up(n, 128) * _round_up(2 * m, 128) < 2 ** 31
            and 2 * c8 * o8 < 2 ** 31)


@functools.cache
def staged_factors(n: int, m: int, norm: str, device: torch.device,
                   adjoint: bool = False):
    """The staged route's DFT factors for a pass, or with ``adjoint`` for
    its adjoint, in bf16: a1 = f2^T (2m, n) zero-padded to (2m rounded up
    to 128, n rounded up to 64) and a3 = i2^T (n, 2m) zero-padded to (n
    rounded up to 128, 2m rounded up to 64), of ``packed_factors`` (of
    ``adjoint_factors``), row-major. Shared between callers, so
    read-only."""
    f2, i2 = (adjoint_factors if adjoint else packed_factors)(n, m, norm,
                                                              device)
    a1 = torch.zeros((_round_up(2 * m, _STAGED_TILE), _round_up(n, _STAGED_K)),
                     dtype=torch.bfloat16, device=device)
    a1[:2 * m, :n] = f2.t()
    a3 = torch.zeros((_round_up(n, _STAGED_TILE), _round_up(2 * m, _STAGED_K)),
                     dtype=torch.bfloat16, device=device)
    a3[:n, :2 * m] = i2.t()
    return a1, a3


def staged_weight(wab: torch.Tensor) -> torch.Tensor:
    """(m, 2, C, O) blocks a | b -> the staged route's (m, 2, C8, O8) bf16:
    C and O rounded up to 8 with zeros in the padding. The mix reads the
    packed form [[a, b], [-b, a]] from them (``pack_blocks`` of them is
    its packed matrix) and makes -b itself."""
    m, _, c, o = wab.shape
    c8, o8 = _round_up(c, 8), _round_up(o, 8)
    make = torch.empty if (c, o) == (c8, o8) else torch.zeros
    out = make((m, 2, c8, o8), dtype=torch.bfloat16, device=wab.device)
    out[:, :, :c, :o] = wab
    return out


def staged_pass_plain(x, a1, a3, wst, m: int, o: int):
    """The staged route's three stages written plainly on its own operands
    (``staged_factors``, ``staged_weight``): x (R, n, C) -> (R, n, O) in
    x's dtype, each stage's products of bf16 values summed in f32 and its
    result rounded where the kernel rounds it. 1. the forward DFT, Z (m, R,
    2 C8) = f2^T @ x mode-major, re | im lanes side by side, in bf16;
    2. the mix, M_k = Z_k @ W_k per mode, (m, R, 2 O8) in bf16; 3. the
    inverse DFT, i2^T @ M, cropped to O channels, in x's dtype; the mix's
    matrix is the packed form of the padded blocks."""
    r, n, c = x.shape
    c8 = _round_up(c, 8)
    xp = torch.zeros((r, n, c8), dtype=torch.float32, device=x.device)
    xp[:, :, :c] = x.to(torch.bfloat16).float()
    z = torch.einsum("jt,rtc->jrc", a1[:2 * m, :n].float(), xp)
    z = z.view(2, m, r, c8).permute(1, 2, 0, 3).reshape(m, r, 2 * c8)
    z = z.to(torch.bfloat16).float()
    o8 = wst.shape[3]
    mz = torch.bmm(z, pack_blocks(wst.float()))
    mz = mz.to(torch.bfloat16).float()
    mk = mz.view(m, r, 2, o8).permute(2, 0, 1, 3).reshape(2 * m, r, o8)
    y = torch.einsum("tj,jro->rto", a3[:n, :2 * m].float(), mk)
    return y[:, :, :o].to(x.dtype)


def spectral_route(compute_dtype, n: int, m: int, c: int, o: int) -> str:
    """The kernel a pass (or an adjoint, with its own c and o) of this
    shape runs on, from the shape alone: in bf16 "staged" (three
    tensor-core products through device memory) where ``staged_fits``; in
    f32 "cuda_cores" (the f32 kernel, in chunks where the shape is beyond
    one launch: ``f32_chunk_plan``). Raises ValueError for a bf16 shape no
    route takes."""
    if compute_dtype != torch.bfloat16:
        return "cuda_cores"
    if staged_fits(n, m, c, o):
        return "staged"
    raise ValueError(f"spectral_axis_pass bf16: no kernel takes n={n}, "
                     f"m={m}, C={c}, O={o} (the staged route takes at most "
                     f"{_STAGED_MAX_MODES} modes)")


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


def _check_entry(x, wab, axis, name, adjoint=False):
    """The checks of both entry points: x's channels are the blocks' C,
    or with ``adjoint`` their O."""
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (H) or 2 (W), got {axis}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if (wab.dim() != 4 or wab.shape[1] != 2
            or wab.shape[3 if adjoint else 2] != x.shape[3]):
        raise ValueError(f"{name} takes the weight's blocks (m, 2, C, O), "
                         f"got {tuple(wab.shape)} for {x.shape[3]} channels")


def spectral_axis_pass(x, wab, axis: int, norm: str, compute_dtype,
                       acc=None):
    """One axis pass over a channels-last (B, H, W, C) tensor along ``axis``
    (1 = H, 2 = W), with the mix weight's blocks ``wab`` (m, 2, C, O)
    (``mix_blocks``) and the DFT factors of ``packed_factors(n, m, norm)``,
    n = x.shape[axis]. Returns (B, H, W, O) in x's dtype; with ``acc``
    given, adds the pass (rounded to x's dtype) into ``acc`` in place and
    returns it, as the two passes of a factorized conv are summed."""
    global launches
    _check_entry(x, wab, axis, "spectral_axis_pass")
    if x.device.type == "cpu":
        f2, i2 = packed_factors(x.shape[axis], wab.shape[0], norm, x.device)
        return _plain_axis_pass(x, f2, i2, pack_blocks(wab), axis,
                                compute_dtype, acc)
    out = _launch(x, wab, axis, norm, False, compute_dtype, acc)
    launches += 1
    return out


def spectral_axis_adjoint(g, wab, axis: int, norm: str, compute_dtype,
                          acc=None):
    """Adjoint of ``spectral_axis_pass`` along ``axis`` with the pass's own
    blocks ``wab`` (m, 2, C, O): g (B, H, W, O) -> (B, H, W, C) in g's
    dtype, added into ``acc`` when it is given. It is the pass with the
    factors of ``adjoint_factors`` and the blocks of ``adjoint_blocks``; on
    a CUDA tensor it launches the pass kernel with them."""
    global adjoint_launches
    _check_entry(g, wab, axis, "spectral_axis_adjoint", adjoint=True)
    wab_t = adjoint_blocks(wab)
    if g.device.type == "cpu":
        f2t, i2t = adjoint_factors(g.shape[axis], wab.shape[0], norm,
                                   g.device)
        return _plain_axis_pass(g, f2t, i2t, pack_blocks(wab_t), axis,
                                compute_dtype, acc)
    out = _launch(g, wab_t, axis, norm, True, compute_dtype, acc)
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


def weight_grad_plain(x, g, f2, i2, axis: int, compute_dtype):
    """Plain PyTorch gradient of one axis pass with respect to its packed
    weight: x (B, H, W, C), g (B, H, W, O) -> dwpk (m, 2C, 2O) in f32.

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


def weight_grad_cost(rows, n, c, o, m, io) -> tuple:
    """(operations, bytes) of one weight gradient over ``rows`` rows of n
    points, c channels in and o out. Operations: the two spectra as dense
    products, 4 n m a channel, and the per-mode product, 8 c o a row and
    mode, as both versions compute them. Bytes: x and g read once in
    ``io``, the blocks' gradient (m, 2, C, O) written once in f32."""
    e = torch.finfo(io).bits // 8
    return (rows * (4.0 * n * m * (c + o) + 8.0 * m * c * o),
            rows * n * (c + o) * e + m * 2 * c * o * 4)


def _axis_rows(t, axis):
    """(rows, rows_lo) of a (B, H, W, C) tensor's rows along ``axis``: B H
    rows of W points (rows_lo H) for axis 2, B W of H (rows_lo W) for 1."""
    b, h, w, _ = t.shape
    return (b * h, h) if axis == 2 else (b * w, w)


def weight_grad_staged_plain(x, g, a1x, a1g, m: int, axis: int):
    """The bf16 weight gradient's kernels written plainly on their own
    operands: x (B, H, W, C) and g (B, H, W, O) in bf16, a1x and a1g the
    pass's and its adjoint's padded a1 (``staged_factors``) -> the blocks'
    gradient (m, 2, C, O) in f32. Each tensor's rows along ``axis`` are
    read through its strides (``_axis_strides``), as the kernel reads them;
    the spectra Z = f2^T x and GS = i2 g, (m, R, 2 C8) and (m, R, 2 O8)
    mode-major with zeros in the padded channels, are summed in f32 from
    bf16 products and rounded to bf16; per mode dwpk_k = Z_k^T GS_k in f32,
    and the blocks' gradient taken from it (``_blocks_grad`` on the padded
    halves)."""
    n, c, o = x.shape[axis], x.shape[3], g.shape[3]
    rows, rows_lo = _axis_rows(x, axis)

    def spectrum(t, a1):
        hi, lo, ax = _axis_strides(t, axis)
        ch = t.shape[3]
        c8 = _round_up(ch, 8)
        tr = torch.as_strided(t, (rows // rows_lo, rows_lo, n, ch),
                              (hi, lo, ax, t.stride(3)), t.storage_offset())
        tp = torch.zeros((rows, n, c8), dtype=torch.float32, device=t.device)
        tp[:, :, :ch] = tr.reshape(rows, n, ch).float()
        with _ieee_f32_matmul():
            z = torch.einsum("jt,rtc->jrc", a1[:2 * m, :n].float(), tp)
        z = z.view(2, m, rows, c8).permute(1, 2, 0, 3).reshape(m, rows, 2 * c8)
        return z.to(torch.bfloat16).float()

    zx, zg = spectrum(x, a1x), spectrum(g, a1g)
    with _ieee_f32_matmul():
        d = torch.bmm(zx.transpose(1, 2), zg)          # (m, 2 C8, 2 O8)
    c8, o8 = zx.shape[2] // 2, zg.shape[2] // 2
    return torch.stack([d[:, :c, :o] + d[:, c8:c8 + c, o8:o8 + o],
                        d[:, :c, o8:o8 + o] - d[:, c8:c8 + c, :o]], dim=1)


def spectral_weight_grad(x, g, m: int, axis: int, norm: str, compute_dtype):
    """Gradient of one axis pass along ``axis`` (m modes, ``norm``) with
    respect to its weight's blocks: x (B, H, W, C), g (B, H, W, O) -> the
    gradient of ``mix_blocks``' (m, 2, C, O) in f32.

    Chosen by device and dtype, as ``spectral_route`` chooses: CUDA
    tensors with x, g and ``compute_dtype`` in bf16 run the staged route's
    kernels (csrc/spectral_staged.cu ``rpde_spectral_wgrad``: both spectra
    by the pass's stage 1, x and g read in place, then the per-mode product
    on the tensor cores, ``weight_grad_staged_plain`` written plainly),
    which raise a ValueError for a shape they do not take; CPU tensors and
    the f32-exact mode (f32 x or compute dtype, whose operands a bf16 stage
    would round) run the plain torch products (``weight_grad_plain``) and
    the gradient of their packing. Both round where the JAX package's VJP
    rounds. It runs inside the span ``rpde.spectral.weight_grad``
    (``utils/tracing.py``)."""
    with span("rpde.spectral.weight_grad"):
        if (x.device.type == "cuda" and x.dtype == g.dtype == compute_dtype
                == torch.bfloat16):
            return _launch_wgrad(x, g, m, axis, norm)
        f2, i2 = packed_factors(x.shape[axis], m, norm, x.device)
        return _blocks_grad(weight_grad_plain(x, g, f2, i2, axis,
                                              compute_dtype))


def _launch_wgrad(x, g, m, axis, norm):
    """``rpde_spectral_wgrad`` on bf16 x and g along ``axis``: its row
    chunks (``rpde_spectral_wgrad_chunks``), its scratch (both spectra in
    bf16, the chunks' f32 sums) and its output."""
    global wgrad_launches
    if x.shape[:3] != g.shape[:3] or x.stride(3) != 1 or g.stride(3) != 1:
        raise ValueError(f"spectral_weight_grad kernel needs x and g over one "
                         f"(B, H, W) grid with unit channel stride, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    n, c, o = x.shape[axis], x.shape[3], g.shape[3]
    rows, rows_lo = _axis_rows(x, axis)
    chunks = _build.library().rpde_spectral_wgrad_chunks(n, m, c, o, rows)
    if not chunks:
        raise ValueError(f"spectral_weight_grad bf16: no kernel takes n={n}, "
                         f"m={m}, C={c}, O={o} over {rows} rows (the staged "
                         f"route takes at most {_STAGED_MAX_MODES} modes, and "
                         f"rows and rows x max(C, O) rounded up to 8 below "
                         f"2^31)")
    c8, o8 = _round_up(c, 8), _round_up(o, 8)
    a1x = staged_factors(n, m, norm, x.device)[0]
    a1g = staged_factors(n, m, norm, x.device, adjoint=True)[0]
    zx = torch.empty(m * rows * 2 * c8, dtype=torch.bfloat16, device=x.device)
    zg = torch.empty(m * rows * 2 * o8, dtype=torch.bfloat16, device=x.device)
    part = torch.empty(chunks * m * 4 * c8 * o8, dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((m, 2, c, o), dtype=torch.float32, device=x.device)
    _cost.add(lambda: weight_grad_cost(rows, n, c, o, m, x.dtype)[0])
    with torch.cuda.device(x.device):
        err = _build.library().rpde_spectral_wgrad(
            x.data_ptr(), g.data_ptr(), a1x.data_ptr(), a1g.data_ptr(),
            zx.data_ptr(), zg.data_ptr(), part.data_ptr(), dw.data_ptr(), n,
            m, c, o, rows, rows_lo, *_axis_strides(x, axis),
            *_axis_strides(g, axis), chunks,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rpde_spectral_wgrad")
    wgrad_launches += 1
    return dw


def _launch(x, wab, axis, norm, adjoint, cd, acc):
    """The route's kernel on x along ``axis`` with blocks ``wab`` (m, 2, C,
    O) and the factors of the pass (``adjoint``: of its adjoint) for
    ``norm``."""
    global wide_launches
    if x.dim() != 4 or x.stride(3) != 1:
        raise ValueError("spectral_axis_pass kernel needs a (B, H, W, C) "
                         "tensor with unit channel stride")
    if cd not in _DTYPES or x.dtype not in _DTYPES:
        raise ValueError(f"spectral_axis_pass kernel takes float32/bfloat16, "
                         f"got x {x.dtype}, compute_dtype {cd}")
    b, h, w, c = x.shape
    n = x.shape[axis]
    if wab.device != x.device:
        raise ValueError(f"spectral_axis_pass: all tensors must be on "
                         f"{x.device}")
    m, o = wab.shape[0], wab.shape[3]
    route = spectral_route(cd, n, m, c, o)
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
    rows, rows_lo = _axis_rows(x, axis)
    _cost.add(lambda: pass_cost(rows, n, c, o, m, x.dtype, cd,
                                acc is not None)[0])
    with torch.cuda.device(x.device):
        if route == "staged":
            _launch_staged(x, wab, axis, norm, adjoint, out, acc is not None,
                           rows, rows_lo)
            wide_launches += 1
        else:
            _launch_f32_chunks(x, wab, axis, norm, adjoint, out,
                               acc is not None, rows, rows_lo)
    return out


def _axis_strides(t, axis):
    """(hi, lo, axis) strides of t's rows (b, h) and points along w for
    axis 2, rows (b, w) and points along h for axis 1."""
    st = t.stride()
    return (st[0], st[1], st[2]) if axis == 2 else (st[0], st[2], st[1])


def _launch_k3(x, wk, f2c, i2c, axis, out, accumulate, rows, rows_lo):
    """One launch of spectral_mix.cu's f32 kernel; x and out may be channel
    slices (unit channel stride)."""
    n, c, o = x.shape[axis], x.shape[3], out.shape[3]
    err = _build.library().rpde_spectral_pass(
        int(x.dtype == torch.bfloat16), x.data_ptr(), f2c.data_ptr(),
        i2c.data_ptr(), wk.data_ptr(), out.data_ptr(), n, wk.shape[0], c, o,
        rows, rows_lo, *_axis_strides(x, axis), *_axis_strides(out, axis),
        int(accumulate), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rpde_spectral_pass")


def _launch_f32_chunks(x, wab, axis, norm, adjoint, out, accumulate, rows,
                       rows_lo):
    """The f32 kernel over ``f32_chunk_plan``: each chunk on its slices of
    x's channels, of the modes (their factors) and of the blocks, written
    into (the first of an output slice, unless ``accumulate``) or added
    into its slice of out. With bf16 x and out each added chunk rounds the
    output slice to bf16 once more."""
    global k3_launches
    n, m = x.shape[axis], wab.shape[0]
    for k0, k1, c0, c1, o0, o1 in f32_chunk_plan(m, x.shape[3], out.shape[3]):
        _check_f32_shape(k1 - k0, c1 - c0, o1 - o0)
        f2c, i2c = kernel_factors_f32(n, m, norm, x.device, adjoint, k0, k1)
        wk = kernel_weight_f32(wab[k0:k1, :, c0:c1, o0:o1])
        _launch_k3(x[..., c0:c1], wk, f2c, i2c, axis, out[..., o0:o1],
                   accumulate or k0 > 0 or c0 > 0, rows, rows_lo)
        k3_launches += 1


def _launch_staged(x, wab, axis, norm, adjoint, out, accumulate, rows,
                   rows_lo):
    """The staged route (csrc/spectral_staged.cu) on x along ``axis``: its
    bf16 scratch for the spectra and the mixed spectra of all rows, and
    its three stages over them."""
    n, c, o, m = x.shape[axis], x.shape[3], out.shape[3], wab.shape[0]
    a1, a3 = staged_factors(n, m, norm, x.device, adjoint)
    wst = staged_weight(wab)
    z = torch.empty(m * rows * 2 * _round_up(c, 8), dtype=torch.bfloat16,
                    device=x.device)
    mz = torch.empty(m * rows * 2 * _round_up(o, 8), dtype=torch.bfloat16,
                     device=x.device)
    err = _build.library().rpde_spectral_staged(
        int(x.dtype == torch.bfloat16), x.data_ptr(), a1.data_ptr(),
        a3.data_ptr(), wst.data_ptr(), z.data_ptr(), mz.data_ptr(),
        out.data_ptr(), n, m, c, o, rows, rows_lo, *_axis_strides(x, axis),
        *_axis_strides(out, axis), int(accumulate),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rpde_spectral_staged")


class SpectralConv2d(torch.autograd.Function):
    """Both axis passes of a factorized spectral conv and their backward:
    the W pass, the H pass added into its output in place, and in the
    backward the W pass's adjoint, the H pass's adjoint added into it (g
    read in place along H), and both weights' gradients. ``opts``
    is (fft_norm, compute_dtype); each weight comes as its blocks
    (``mix_blocks``) and its gradient goes back as theirs."""

    @staticmethod
    def forward(ctx, opts, x, wab_y, wab_x):
        norm, cd = opts
        out = spectral_axis_pass(x, wab_y, 2, norm, cd)
        spectral_axis_pass(x, wab_x, 1, norm, cd, acc=out)
        ctx.opts = opts
        ctx.save_for_backward(x, wab_y, wab_x)
        return out

    @staticmethod
    def backward(ctx, g):
        norm, cd = ctx.opts
        x, wab_y, wab_x = ctx.saved_tensors
        g = g.contiguous()
        dx = dwy = dwx = None
        if ctx.needs_input_grad[1]:
            dx = spectral_axis_adjoint(g, wab_y, 2, norm, cd)
            spectral_axis_adjoint(g, wab_x, 1, norm, cd, acc=dx)
        if ctx.needs_input_grad[2]:
            dwy = spectral_weight_grad(x, g, wab_y.shape[0], 2, norm, cd)
            dwy = dwy.to(wab_y.dtype)
        if ctx.needs_input_grad[3]:
            dwx = spectral_weight_grad(x, g, wab_x.shape[0], 1, norm, cd)
            dwx = dwx.to(wab_x.dtype)
        return None, dx, dwy, dwx


class SpectralAxis(torch.autograd.Function):
    """One axis pass (``opts`` = (fft_norm, compute_dtype, axis)) and its
    backward: the adjoint for x and the blocks' gradient from x and g,
    through the same kernels as ``SpectralConv2d``."""

    @staticmethod
    def forward(ctx, opts, x, wab):
        norm, cd, axis = opts
        ctx.opts = opts
        ctx.save_for_backward(x, wab)
        return spectral_axis_pass(x, wab, axis, norm, cd)

    @staticmethod
    def backward(ctx, g):
        norm, cd, axis = ctx.opts
        x, wab = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dx = spectral_axis_adjoint(g, wab, axis, norm, cd)
        if ctx.needs_input_grad[2]:
            dw = spectral_weight_grad(x, g, wab.shape[0], axis, norm, cd)
            dw = dw.to(wab.dtype)
        return None, dx, dw


def factorized_spectral_conv_2d_pallas2_slabs(x, weight_y, weight_x,
                                              n_modes: int, shard,
                                              fft_norm: str = "ortho",
                                              compute_dtype=torch.bfloat16):
    """``factorized_spectral_conv_2d_pallas2`` on this rank's slab x (B,
    H/S, W, C) of a grid sharded over "spatial" (``shard``, a
    ``parallel.spatial.Shard``): the W pass on the slab, the H pass on
    the pencils (B, H, W/S, C) of an all-to-all, through the same launch
    as in one process, and back, added to the W pass's output (a separate
    add: the H pass cannot accumulate into the W pass's output across the
    all-to-all). The backward keeps x's pencils; each weight's gradient is
    this rank's partial sum (the trainer sums it over "spatial")."""
    _, hs, w, _ = x.shape
    h = hs * shard.size
    cd = compute_dtype if compute_dtype is not None else x.dtype
    wab_y = mix_blocks(weight_y, min(n_modes, w // 2 + 1)).float()
    wab_x = mix_blocks(weight_x, min(n_modes, h // 2 + 1)).float()
    out = SpectralAxis.apply((fft_norm, cd, 2), x, wab_y)
    pencil = spatial.slab_to_pencil(x, shard.group)
    along_h = SpectralAxis.apply((fft_norm, cd, 1), pencil, wab_x)
    return out + spatial.pencil_to_slab(along_h, shard.group)


def factorized_spectral_conv_2d_pallas2(x, weight_y, weight_x, n_modes: int,
                                        fft_norm: str = "ortho",
                                        compute_dtype=torch.bfloat16):
    """Both FFNO axis passes through the kernels: ``weight_y`` along W
    (the last spatial axis) and ``weight_x`` along H, summed in x's dtype.
    x: (B, H, W, C) channels-last -> (B, H, W, C). ``compute_dtype`` None
    computes in x's dtype. Differentiable through ``SpectralConv2d``; the
    gradient of each weight's blocks reaches its (C, O, n_modes, 2) weight
    through ``mix_blocks``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"factorized_spectral_conv_2d_pallas2 runs on cpu "
                         f"or cuda, not {x.device}")
    _, h, w, _ = x.shape
    cd = compute_dtype if compute_dtype is not None else x.dtype
    wab_y = mix_blocks(weight_y, min(n_modes, w // 2 + 1)).float()
    wab_x = mix_blocks(weight_x, min(n_modes, h // 2 + 1)).float()
    return SpectralConv2d.apply((fft_norm, cd), x, wab_y, wab_x)
