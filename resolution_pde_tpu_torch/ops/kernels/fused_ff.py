"""Fused FFNO FeedForward: the hand-written CUDA kernels and their plain versions.

Counterpart of resolution_pde_tpu/ops/pallas/fused_ff.py:
``Dense -> GELU -> ... -> Dense [-> LayerNorm] [+ residual]`` over the
rows of ``x``, with products in ``compute_dtype`` accumulated in f32, bias,
GELU, LayerNorm (eps 1e-5) and residual in f32, each hidden activation
rounded to ``compute_dtype`` and the output in x's dtype. The forward
kernel is ``csrc/fused_ff.cu`` (bf16 products on the tensor cores, the
weights streamed through shared memory; f32 products in IEEE f32 on the
CUDA cores, the weights streamed through shared memory too); the backward
kernel, which recomputes the
hidden activations per tile (or reads the pre-activations the forward
saved) and reduces the weight gradients over the rows in a fixed order, is
``csrc/fused_ff_bwd.cu`` (bf16 products on the tensor cores; f32 products
in IEEE f32 on the CUDA cores, the weights streamed through shared
memory).

``fused_feedforward`` is a ``torch.autograd.Function``: for a tensor on the
CPU it runs the plain forward and the plain backward below, and for a CUDA
tensor it launches the kernels; it never falls back from one to the other,
and it never differentiates the plain forward with autograd.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from resolution_pde_tpu_torch.ops.kernels import _build, _cost

LN_EPS = 1e-5  # torch.nn.LayerNorm default (reference parity)
MAX_LAYERS = 32  # kMaxLayers of csrc/fused_ff.cuh
_SQRT_2_OVER_PI = 0.7978845608028654
_INV_SQRT_2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327

# kernel launches in this process (the plain versions never count)
launches = 0       # forward, csrc/fused_ff.cu
bwd_launches = 0   # backward, csrc/fused_ff_bwd.cu


def cost(n, dims, ln, residual, dtype, passes, saved=0) -> tuple:
    """(operations, bytes) of a FeedForward call over ``n`` rows of the
    chain ``dims``: the products, ``passes`` times the forward's (1 for
    the forward, 3 for the recompute backward, 2 for the backward that
    reads ``saved`` pre-activations a row), and the bytes the function
    must move: the activations in ``dtype`` (x and out, and a residual,
    for the forward; x, g and dx, and the saved pre-activations, for the
    backward), the f32 parameters (and their gradients for the
    backward)."""
    e = torch.finfo(dtype).bits // 8
    macs = sum(a * b for a, b in zip(dims, dims[1:]))
    params = macs + sum(dims[1:]) + (2 * dims[-1] if ln else 0)
    acts = n * ((2 * dims[0] + dims[-1] + saved) if passes > 1
                else (dims[0] + dims[-1])) * e
    nbytes = (acts + (n * dims[-1] * e if residual else 0)
              + params * 4 * (2 if passes > 1 else 1))
    return 2.0 * n * macs * passes, nbytes


def _gelu(z: torch.Tensor, approx: bool) -> torch.Tensor:
    if approx:
        u = _SQRT_2_OVER_PI * (z + 0.044715 * z * z * z)
        return 0.5 * z * (1.0 + torch.tanh(u))
    return 0.5 * z * (1.0 + torch.erf(z * _INV_SQRT_2))


def _gelu_grad(z: torch.Tensor, approx: bool) -> torch.Tensor:
    if approx:
        z2 = z * z
        t = torch.tanh(_SQRT_2_OVER_PI * (z + 0.044715 * z * z2))
        du = _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * z2)
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du
    cdf = 0.5 * (1.0 + torch.erf(z * _INV_SQRT_2))
    return cdf + z * (_INV_SQRT_2PI * torch.exp(-0.5 * z * z))


def _n_saved(n_layers: int, has_ln: bool) -> int:
    """Pre-activations the forward saves for the backward: without
    LayerNorm the backward never reads the last layer's."""
    return n_layers if has_ln else n_layers - 1


def fused_feedforward_reference(x, kernels, biases, ln=None, residual=None, *,
                                approx_gelu: bool = True,
                                compute_dtype=torch.bfloat16,
                                save_acts: bool = False):
    """Plain PyTorch version of the forward kernel, with its rounding points.

    x: (..., C_in). kernels: (in_i, out_i) matrices; biases: (out_i,);
    ln: optional (scale, bias), each (C_out,); residual: optional
    (..., C_out). Products take their inputs rounded to ``compute_dtype``
    and multiply them in f32, which is exact for bf16 inputs, so the sum is
    the kernel's f32 accumulation up to its order. With ``save_acts`` it
    returns ``(out, zs)``: the pre-activations, (N, out_i) each, rounded to
    ``compute_dtype``, of every layer with LayerNorm and of all but the
    last without.
    """
    cd = compute_dtype
    c_out = kernels[-1].shape[1]
    n_save = _n_saved(len(kernels), ln is not None)
    h = x.reshape(-1, x.shape[-1]).to(cd)
    z = None
    zs = []
    for i, (k, b) in enumerate(zip(kernels, biases)):
        z = h.float() @ k.to(cd).float() + b.float()
        if save_acts and i < n_save:
            zs.append(z.to(cd))
        if i < len(kernels) - 1:
            h = _gelu(z, approx_gelu).to(cd)
    if ln is not None:
        mu = z.mean(dim=-1, keepdim=True)
        zc = z - mu
        var = (zc * zc).mean(dim=-1, keepdim=True)
        z = zc * torch.rsqrt(var + LN_EPS) * ln[0].float() + ln[1].float()
    if residual is not None:
        z = z + residual.reshape(-1, c_out).float()
    out = z.to(x.dtype).reshape(*x.shape[:-1], c_out)
    return (out, zs) if save_acts else out


def fused_feedforward_bwd_reference(x, g, kernels, biases, ln=None, *,
                                    approx_gelu: bool = True,
                                    compute_dtype=torch.bfloat16,
                                    zs_saved=None):
    """Plain PyTorch version of the backward kernel, with the JAX kernel's
    rounding points: the hidden activations recomputed as the forward does
    (or rebuilt from ``zs_saved``, the forward's ``save_acts`` output), the
    LayerNorm backward and the GELU gradient in f32, each dz rounded to
    ``compute_dtype`` before both its products, dx in x's dtype, and the
    weight, bias and LayerNorm gradients summed in f32 and cast to each
    parameter's dtype. g: the cotangent of the output, (..., C_out).
    Returns (dx, dks, dbs, dln); dln is None without LayerNorm. The
    residual's gradient is g itself."""
    cd = compute_dtype
    n_layers = len(kernels)
    h = x.reshape(-1, x.shape[-1]).to(cd)
    if zs_saved is not None:
        if len(zs_saved) != _n_saved(n_layers, ln is not None):
            raise ValueError(f"zs_saved holds {len(zs_saved)} tensors; "
                             f"{_n_saved(n_layers, ln is not None)} expected")
        zs = [z.reshape(h.shape[0], -1).float() for z in zs_saved]
        hs = [h] + [_gelu(zs[i], approx_gelu).to(cd)
                    for i in range(n_layers - 1)]
    else:
        hs, zs = [], []
        for i, (k, b) in enumerate(zip(kernels, biases)):
            hs.append(h)
            z = h.float() @ k.to(cd).float() + b.float()
            zs.append(z)
            if i < n_layers - 1:
                h = _gelu(z, approx_gelu).to(cd)
    gg = g.reshape(h.shape[0], -1).float()
    dln = None
    if ln is not None:
        z = zs[-1]
        mu = z.mean(dim=-1, keepdim=True)
        zc = z - mu
        var = (zc * zc).mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(var + LN_EPS)
        xhat = zc * rstd
        dxhat = gg * ln[0].float()
        dz = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                     - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
        dln = ((gg * xhat).sum(0).to(ln[0].dtype), gg.sum(0).to(ln[1].dtype))
    else:
        dz = gg
    dks, dbs = [None] * n_layers, [None] * n_layers
    dh = None
    for i in reversed(range(n_layers)):
        dz_c = dz.to(cd).float()
        dks[i] = (hs[i].float().t() @ dz_c).to(kernels[i].dtype)
        dbs[i] = dz.sum(0).to(biases[i].dtype)
        dh = dz_c @ kernels[i].to(cd).float().t()
        if i > 0:
            dz = dh * _gelu_grad(zs[i - 1], approx_gelu)
    dx = dh.to(x.dtype).reshape(x.shape)
    return dx, dks, dbs, dln


_IO_DTYPES = (torch.float32, torch.bfloat16)


def _chain_dims(x, kernels, biases, ln, residual, cd) -> list:
    """Check what the kernels take; return the chain's widths."""
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
    return dims


def _packed_weights(kernels, cd, transpose: bool = False,
                    pad: int = 1) -> torch.Tensor:
    """Every layer's kernel in ``cd``, packed one after another row-major:
    (in, out) each, or (out, in) with ``transpose``, each zero-padded to
    multiples of ``pad`` in both dimensions."""
    out = []
    for k in kernels:
        k = (k.t() if transpose else k).to(cd)
        rows, cols = (-(-d // pad) * pad for d in k.shape)
        k = torch.nn.functional.pad(k, (0, cols - k.shape[1],
                                        0, rows - k.shape[0]))
        out.append(k.contiguous().reshape(-1))
    return torch.cat(out)


def _forward_weights(kernels, cd) -> torch.Tensor:
    """The packing the forward kernel reads: row-major (in, out) kernels,
    each zero-padded to whole 16 x 16 fragments in bf16 (its tensor-core
    products) and to multiples of 4 in f32 (its f32 products stream
    16-byte pieces of each layer's weight into shared memory), as the
    backward's ``w``."""
    return _packed_weights(kernels, cd, pad=16 if cd == torch.bfloat16 else 4)


# The arithmetic of the backward kernel's planner (``plan``,
# csrc/fused_ff_bwd.cu), mirrored so that a chain it cannot take is refused
# before any launch: the shared memory a block may take, its threads, the
# tallest tile, the column sums' scratch (floats a thread), and the f32
# products' weight ring (``f32_ring_floats``, csrc/fused_ff.cuh).
_SMEM_BYTES = 232448
_BWD_THREADS = 512
_BWD_MAX_TILE_ROWS = 64
_BWD_COLUMN_SUMS = 3
_F32_SLICE_ROWS, _F32_CHUNK_COLS = 32, 256


def _pad(d: int, to: int) -> int:
    return -(-d // to) * to


def _f32_ring_floats(width: int, threads: int) -> int:
    """Floats of f32_tile_gemm's ring for outputs up to ``width`` (padded
    to 4) wide: two stages of 32 rows of its first column chunk (at most
    256 columns), and at least 16 floats a thread."""
    return max(2 * _F32_SLICE_ROWS * min(width, _F32_CHUNK_COLS),
               16 * threads)


def backward_tile_rows(dims, has_ln: bool, compute_dtype) -> int:
    """Rows of the backward kernel's tile for the chain ``dims`` (widths
    dims[0] -> ... -> dims[-1]), as its planner picks them: the tallest of
    64, 32, .. rows whose buffers (the pre-activations in f32, their
    LayerNorm statistics, h_0 and two rows as wide as the widest layer in
    the compute type), beside the column sums' scratch and, in f32, the
    weight ring, fit a block's shared memory, with at least the least tile:
    16 rows in bf16 (whole tensor-core fragments), 8 in f32 (the products'
    register tiles). Where the least tile does not fit with its
    pre-activations (factor-4 chains wider than 256), they go to device
    memory and the tile is the tallest that fits without them. Raises
    ValueError when not even that fits: factor-4 chains wider than about
    780 in bf16 and 555 in f32."""
    bf16 = compute_dtype == torch.bfloat16
    z_ld, dz = sum(dims[1:]), max(dims[1:])
    fixed = _BWD_COLUMN_SUMS * _BWD_THREADS * 4
    if bf16:
        h0_ld, dz_ld, size = _pad(dims[0], 16) + 8, _pad(dz, 16) + 8, 2
        z_ld += 4
    else:
        widest = max(_pad(d, 4) for d in dims)
        h0_ld, dz_ld, size = _pad(dims[0], 4) + 4, _pad(dz, 4) + 4, 4
        fixed += _f32_ring_floats(widest, _BWD_THREADS) * 4
    z_row, rest_row = z_ld * 4, 16 + (h0_ld + 2 * dz_ld) * size

    def tallest(per_row):
        tr = _BWD_MAX_TILE_ROWS
        while tr > 1 and tr * per_row + fixed > _SMEM_BYTES:
            tr //= 2
        return tr if tr * per_row + fixed <= _SMEM_BYTES else 0

    least = 16 if bf16 else 8
    tr = tallest(z_row + rest_row)
    if tr < least:
        tr = tallest(rest_row)
    if tr < least:
        raise ValueError(
            f"fused_feedforward backward ({'bf16' if bf16 else 'f32'}): "
            f"widths {list(dims)} need {least} rows of {rest_row} bytes "
            f"(their pre-activations in device memory) beside {fixed} "
            f"bytes, {least * rest_row + fixed} bytes of shared memory; a "
            f"block has {_SMEM_BYTES}")
    return tr


# The forward kernel's planner (``plan``, csrc/fused_ff.cu): the bf16
# kernel's warps, the widths of its wide warp tiles' passes, its weight
# ring (stages of 32 contraction rows), and the f32 kernels' threads and
# the older f32 kernel's shared-memory budget (``kSmemBudget``).
_FWD_WARPS = 8
_FWD_WIDE_COLS = 256
_FWD_RING_STAGES, _FWD_SLICE_ROWS = 2, 32
_F32_FWD_THREADS = 512
_F32_WIDE_SMEM = 200 * 1024


def forward_tile_rows(dims, has_ln: bool, has_residual: bool,
                      compute_dtype, io_dtype) -> tuple:
    """The forward kernel's route and tile rows for the chain ``dims``, as
    its planner picks them: ``("mma", rows)`` for bf16 products (the
    tallest of 64, 32 and 16 rows whose two activation buffers, each also
    holding the last layer's f32 sums and the residual tile, fit beside
    the weight ring), ``("f32_tiles", rows)`` for f32 products on
    f32_tile_gemm (64 down to 8 rows, its buffers beside its ring) and
    ``("f32_wide", rows)`` for f32 chains too wide for that. The plan does
    not depend on ``has_ln``; it is taken for the same signature as
    ``backward_tile_rows``. Raises ValueError, naming the widths and the
    bytes, where no tile fits: bf16 factor-4 chains from width 837 (833
    with f32 x, residual and output)."""
    del has_ln  # LayerNorm runs on the buffers the plan already holds
    dims = list(dims)
    c_out, widest = dims[-1], max(dims)
    if compute_dtype == torch.bfloat16:
        io_size = torch.finfo(io_dtype).bits // 8
        h_ld, z_ld = _pad(widest, 16) + 8, _pad(c_out, 16) + 8
        for tr in (64, 32, 16):
            mt = 2 if tr >= 32 else 1   # narrow warp tiles' fragments high
            stage_rows = 0
            for np_ in (_pad(d, 16) for d in dims[1:]):
                wide = tr == 64 and np_ >= _FWD_WIDE_COLS
                cols = (_FWD_WIDE_COLS if wide
                        else _FWD_WARPS // (tr // (16 * mt)) * 16)
                stage_rows = max(stage_rows, min(cols, np_))
            z_bytes = tr * z_ld * 4
            res = tr * c_out * io_size if has_residual else 0
            buf = _pad(max(tr * h_ld * 2, z_bytes + res), 16)
            ring = (_FWD_RING_STAGES * _FWD_SLICE_ROWS * (stage_rows + 8)
                    * 2)
            if 2 * buf + ring <= _SMEM_BYTES:
                return "mma", tr
        raise ValueError(
            f"fused_feedforward forward (bf16): widths {dims} need two "
            f"16-row activation buffers of {buf} bytes beside a {ring}-byte "
            f"weight ring, {2 * buf + ring} bytes of shared memory; a block "
            f"has {_SMEM_BYTES}")
    wp = _pad(widest, 4)
    h_ld = (wp + 27) // 32 * 32 + 4
    ring = _f32_ring_floats(wp, _F32_FWD_THREADS) * 4
    for tr in (64, 32, 16, 8):
        threads = (-(-min(wp, _F32_CHUNK_COLS) // 32) * (-(-tr // 8)) * 8)
        if (2 * tr * h_ld * 4 + ring <= _SMEM_BYTES
                and threads <= _F32_FWD_THREADS):
            return "f32_tiles", tr
    tr = 64
    while tr >= 1:
        if (2 * tr * widest + tr * c_out) * 4 <= _F32_WIDE_SMEM:
            return "f32_wide", tr
        tr //= 2
    raise ValueError(
        f"fused_feedforward forward (f32): widths {dims} need "
        f"{(2 * widest + c_out) * 4} bytes of shared memory a row; the "
        f"kernel has {_F32_WIDE_SMEM}")


# the launcher's planner, once a chain: dims as a tuple, the rest as
# forward_tile_rows takes them (a chain it refuses raises every time)
_forward_plan = functools.lru_cache(maxsize=None)(forward_tile_rows)


def _backward_weights(kernels, cd) -> tuple:
    """The packings the backward kernel reads, ``(w, wt)``: the (in, out)
    kernels and their transposes, each zero-padded to multiples of 16 in
    bf16 (whole tensor-core fragments) and of 4 in f32 (the f32 products
    stream 16-byte pieces of each layer's weight into shared memory)."""
    pad = 16 if cd == torch.bfloat16 else 4
    return (_packed_weights(kernels, cd, pad=pad),
            _packed_weights(kernels, cd, transpose=True, pad=pad))


def fused_feedforward_fwd(x, kernels, biases, ln=None, residual=None, *,
                          approx_gelu: bool = True,
                          compute_dtype=torch.bfloat16,
                          save_acts: bool = False):
    """The forward kernel (CUDA tensors), with the arguments of
    ``fused_feedforward_reference``. Returns (out, zs): zs is None, or with
    ``save_acts`` the saved pre-activations packed per row, (N, sum of
    their widths) in ``compute_dtype``, as ``fused_feedforward_bwd`` reads
    them."""
    global launches
    cd, save = compute_dtype, save_acts
    dims = _chain_dims(x, kernels, biases, ln, residual, cd)
    n = math.prod(x.shape[:-1])
    out = torch.empty((*x.shape[:-1], dims[-1]), dtype=x.dtype,
                      device=x.device)
    zs = None
    if save:
        width = sum(dims[1:_n_saved(len(kernels), ln is not None) + 1])
        zs = torch.empty((n, width), dtype=cd, device=x.device)
    if n == 0:
        return out, zs
    _forward_plan(tuple(dims), ln is not None, residual is not None, cd,
                  x.dtype)
    w = _forward_weights(kernels, cd)
    b = torch.cat([t.float().reshape(-1) for t in biases])
    ln_s = ln[0].float().contiguous() if ln is not None else None
    ln_b = ln[1].float().contiguous() if ln is not None else None
    c_dims = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(x.device):
        err = _build.library().rpde_fused_ff_forward(
            int(cd == torch.bfloat16), int(x.dtype == torch.bfloat16),
            x.data_ptr(), residual.data_ptr() if residual is not None else None,
            out.data_ptr(), zs.data_ptr() if save and zs.numel() else None,
            w.data_ptr(), b.data_ptr(),
            ln_s.data_ptr() if ln_s is not None else None,
            ln_b.data_ptr() if ln_b is not None else None,
            c_dims, len(kernels), n, int(bool(approx_gelu)),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rpde_fused_ff_forward")
    launches += 1
    _cost.add(lambda: cost(n, dims, ln is not None, residual is not None,
                           x.dtype, 1)[0])
    return out, zs


def fused_feedforward_bwd(x, g, kernels, biases, ln=None, *,
                          approx_gelu: bool = True,
                          compute_dtype=torch.bfloat16, zs_saved=None):
    """The backward kernel (CUDA tensors), with the arguments and results of
    ``fused_feedforward_bwd_reference``; ``zs_saved`` is the packed
    (N, sum of widths) tensor the forward kernel saved, or None to
    recompute. Each weight gradient is summed per block over its row tiles
    into its own f32 slab, and the slabs are summed in block order by a
    second kernel: no atomics, so a run repeats bit for bit."""
    global bwd_launches
    cd = compute_dtype
    dims = _chain_dims(x, kernels, biases, ln, None, cd)
    n_layers, c_out = len(kernels), dims[-1]
    n = math.prod(x.shape[:-1])
    g = g.reshape(n, c_out).contiguous()
    if g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must be a {x.dtype} tensor on {x.device}")
    if zs_saved is not None:
        width = sum(dims[1:_n_saved(n_layers, ln is not None) + 1])
        if (zs_saved.shape != (n, width) or zs_saved.dtype != cd
                or not zs_saved.is_contiguous()):
            raise ValueError(f"zs_saved must be a contiguous ({n}, {width}) "
                             f"{cd} tensor")
    n_w = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    n_b = sum(dims[1:])
    size = n_w + n_b + (2 * c_out if ln is not None else 0)
    dx = torch.empty_like(x)
    grads = torch.zeros(size, dtype=torch.float32, device=x.device)
    if n > 0:
        tile_rows = backward_tile_rows(dims, ln is not None, cd)
        lib = _build.library()
        bf16 = int(cd == torch.bfloat16)
        c_dims = (ctypes.c_int * len(dims))(*dims)
        slab = lib.rpde_fused_ff_backward_slab(bf16, c_dims, n_layers,
                                               int(ln is not None))
        if slab < 0:
            raise RuntimeError(f"fused_feedforward backward: the kernel's "
                               f"planner refused widths {dims}, which "
                               "backward_tile_rows takes")
        # the kernel's grid is at most one block a slot of the card and
        # one a tile, so no more scratch than that is allocated
        max_blocks = min(2 * torch.cuda.get_device_properties(
            x.device).multi_processor_count,
            -(-n // tile_rows))
        partials = torch.empty(max_blocks * slab, dtype=torch.float32,
                               device=x.device)
        w, wt = _backward_weights(kernels, cd)
        b = torch.cat([t.float().reshape(-1) for t in biases])
        ln_s = ln[0].float().contiguous() if ln is not None else None
        with torch.cuda.device(x.device):
            err = lib.rpde_fused_ff_backward(
                bf16, int(x.dtype == torch.bfloat16),
                x.data_ptr(), g.data_ptr(),
                zs_saved.data_ptr() if zs_saved is not None
                and zs_saved.numel() else None,
                dx.data_ptr(), w.data_ptr(), wt.data_ptr(), b.data_ptr(),
                ln_s.data_ptr() if ln_s is not None else None,
                partials.data_ptr(), grads.data_ptr(), c_dims, n_layers, n,
                int(bool(approx_gelu)), max_blocks,
                torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "rpde_fused_ff_backward")
        bwd_launches += 1
        _cost.add(lambda: cost(
            n, dims, ln is not None, False, x.dtype,
            2 if zs_saved is not None else 3,
            zs_saved.shape[1] if zs_saved is not None else 0)[0])
    dks, off = [], 0
    for k, (a, b) in zip(kernels, zip(dims[:-1], dims[1:])):
        dks.append(grads[off:off + a * b].view(a, b).to(k.dtype))
        off += a * b
    dbs = []
    for bias, d in zip(biases, dims[1:]):
        dbs.append(grads[off:off + d].to(bias.dtype))
        off += d
    dln = None
    if ln is not None:
        dln = (grads[off:off + c_out].to(ln[0].dtype),
               grads[off + c_out:off + 2 * c_out].to(ln[1].dtype))
    return dx, dks, dbs, dln


class FusedFeedForward(torch.autograd.Function):
    """The fused FeedForward with its backward: kernels for CUDA tensors,
    the plain versions for CPU tensors. ``opts`` is
    (approx_gelu, compute_dtype, save_acts)."""

    @staticmethod
    def forward(ctx, opts, x, residual, ln_s, ln_b, *params):
        approx, cd, save_acts = opts
        n_layers = len(params) // 2
        kernels, biases = params[:n_layers], params[n_layers:]
        ln = (ln_s, ln_b) if ln_s is not None else None
        # pre-activations are saved only where a backward will read them
        save = save_acts and any(ctx.needs_input_grad)
        if x.device.type == "cpu":
            out = fused_feedforward_reference(
                x, kernels, biases, ln, residual, approx_gelu=approx,
                compute_dtype=cd, save_acts=save)
            out, zs = out if save else (out, [])
        else:
            out, zs = fused_feedforward_fwd(
                x, kernels, biases, ln, residual, approx_gelu=approx,
                compute_dtype=cd, save_acts=save)
            zs = [zs] if save else []
        ctx.opts = (approx, cd, save)
        ctx.n_layers = n_layers
        ctx.has_residual = residual is not None
        ctx.save_for_backward(x, ln_s, ln_b, *params, *zs)
        return out

    @staticmethod
    def backward(ctx, g):
        approx, cd, save = ctx.opts
        x, ln_s, ln_b, *rest = ctx.saved_tensors
        n = ctx.n_layers
        kernels, biases, zs = rest[:n], rest[n:2 * n], rest[2 * n:]
        ln = (ln_s, ln_b) if ln_s is not None else None
        g = g.contiguous()
        if x.device.type == "cpu":
            dx, dks, dbs, dln = fused_feedforward_bwd_reference(
                x, g, kernels, biases, ln, approx_gelu=approx,
                compute_dtype=cd, zs_saved=zs if save else None)
        else:
            dx, dks, dbs, dln = fused_feedforward_bwd(
                x, g, kernels, biases, ln, approx_gelu=approx,
                compute_dtype=cd, zs_saved=zs[0] if save else None)
        # the residual enters the output additively: its cotangent is g
        dres = g if ctx.has_residual else None
        dln_s, dln_b = dln if dln is not None else (None, None)
        return (None, dx, dres, dln_s, dln_b, *dks, *dbs)


def fused_feedforward(x, kernels, biases, ln=None, residual=None, *,
                      approx_gelu: bool = True, compute_dtype=torch.bfloat16,
                      save_acts: bool = False):
    """Fused Dense->GELU->...->Dense[->LayerNorm][+residual] chain,
    differentiable through ``FusedFeedForward``.

    Arguments as ``fused_feedforward_reference``. ``save_acts`` keeps the
    pre-activations (in ``compute_dtype``) for the backward, which then
    skips its recompute products (the JAX package's ff_impl
    'fused_saved'); it changes nothing when no gradient is needed.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_feedforward runs on cpu or cuda, not "
                         f"{x.device}")
    ln_s, ln_b = ln if ln is not None else (None, None)
    return FusedFeedForward.apply(
        (bool(approx_gelu), compute_dtype, bool(save_acts)), x, residual,
        ln_s, ln_b, *kernels, *biases)
