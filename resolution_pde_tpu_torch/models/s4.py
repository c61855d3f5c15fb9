"""S4 family: the S4D (diagonal) and S4 (DPLR) kernel layers, FFTConv,
S4Block, S4D, the 1D PDE wrapper S4Model, the N-d S4ND layer and the 2D
PDE wrapper S4NDModel, and the recurrent step functions.

Counterpart of resolution_pde_tpu/models/s4.py. Parameters keep the
JAX package's names, shapes and parameterization (the full-N DPLR
spectrum; C stored as (..., 2) real/imaginary pairs); module names follow
the reference PyTorch state_dict (``encoder``, ``decoder``,
``s4_layers.{i}.layer.kernel``, ``s4_layers.{i}.layer.D``,
``s4_layers.{i}.output_linear``), so ``utils.jax_bridge`` maps a JAX
parameter tree onto them. Layout: channels-last (B, L, H) inside, and
(B, C, L) at S4Model's boundary, as in JAX.

``kernel_impl`` selects how a kernel layer materializes its SSM kernel:
'jnp' (plain torch, ``ops.ssm``; the name is the JAX package's) or
'pallas' (the hand-written CUDA kernels, ``ops.kernels.vandermonde`` for
the diagonal layer and ``ops.kernels.cauchy`` for the DPLR one). The two
routes compute the same function, so it is no new capability; 'pallas'
accepts exactly what the JAX package's pallas route accepts and raises the
same errors otherwise, and it is forward-only: ``backward()`` through it
raises, and training takes 'jnp'. S4Block, FFTConvLayer and the kernel
layers carry the field, as in JAX; the port's S4Model also forwards it to
its blocks, so the kernels are reachable from the shipped model (the JAX
S4Model builds its blocks with the default 'jnp').

S4NDModel takes the field too and forwards it to its layers' kernels
through ``kernel_args`` (the JAX S4NDModel, with no such field, runs
'jnp'), which is how the S4ND path reaches the kernels.

Initializers draw from the JAX module's distributions, from an explicit
``torch.Generator``: the numbers differ from JAX's, so the tests carry
JAX weights over with ``utils.jax_bridge``.

``s4d_recurrent_step_fn`` and ``dplr_recurrent_step_fn`` build a kernel
layer's recurrent form, ``(init_state, step)``: plain functions on
tensors that a Python loop or a CUDA graph drives, equal to the
convolution up to roundoff.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from resolution_pde_tpu_torch.models.layers import Dropout, gelu
from resolution_pde_tpu_torch.ops import ssm as ssm_ops
from resolution_pde_tpu_torch.ops.grids import concat_grid_1d, concat_grid_2d
from resolution_pde_tpu_torch.ops.kernels.cauchy import dplr_kernel_pallas
from resolution_pde_tpu_torch.ops.kernels.vandermonde import s4d_kernel_pallas
from resolution_pde_tpu_torch.ops.spectral import irfftn

ACTIVATIONS_S4 = {
    "gelu": gelu,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "id": lambda x: x,
    "identity": lambda x: x,
}
KERNEL_IMPLS = ("jnp", "pallas")
# Parameter names of the state-space parameters, which the Trainer never
# weight-decays (resolution_pde_tpu/models/s4.py SSM_PARAM_NAMES)
SSM_PARAM_NAMES = (
    "log_dt", "log_A_real", "A_imag",
    "Lambda_log_neg_re", "Lambda_im", "P_vec", "B_vec",
)


def dense(in_features: int, features: int, generator=None) -> nn.Linear:
    """A Linear with flax ``nn.Dense``'s initializers: lecun_normal weight
    (truncated normal, variance 1/fan_in) and zero bias."""
    lin = torch.nn.utils.skip_init(nn.Linear, in_features, features)
    std = math.sqrt(1.0 / in_features) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        lin.bias.zero_()
    return lin


def _param(a) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(np.asarray(a, np.float32)).clone())


def _dt_init(shape, dt_min, dt_max, dt_transform, dt_fast, generator):
    """log-uniform timestep in [dt_min, dt_max], stored through the dt
    parameterization (the inverse transform, then asinh with dt_fast)."""
    u = torch.rand(shape, generator=generator)
    raw = u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min)
    if dt_transform != "exp":
        raw = ssm_ops.inv_param_transform_tensor(torch.exp(raw), dt_transform)
    if dt_fast:
        raw = torch.asinh(raw)
    return nn.Parameter(raw)


def _check_impl(kernel_impl: str) -> None:
    if kernel_impl not in KERNEL_IMPLS:
        raise ValueError(f"unknown kernel_impl {kernel_impl!r}; expected one "
                         f"of {', '.join(KERNEL_IMPLS)}")


class S4DKernelLayer(nn.Module):
    """Diagonal SSM kernel (models/s4d.py:33-69; option surface of
    SSMKernelDiag, models/s4.py:987-1189). ``forward(L)`` returns
    (channels, H, L).

    disc: 'zoh' | 'bilinear' | 'dss' (the pallas route: zoh only). n_ssm:
    independent A copies, tiled across the H features (None: H). dt_tie
    False stores one dt per (feature, state). dt_transform/dt_fast: the
    timestep's parameterization (dt_fast stores asinh). real_transform /
    imag_transform: for -Re A / -Im A; with imag_transform 'none' A_imag is
    the signed imaginary part. bandlimit: zero C on modes whose discrete
    frequency dt |Im A| / 2pi exceeds bandlimit / 2. is_real: a real SSM,
    d_state real states. measure: 'lin', 'inv', 'legs' or 'diag' (first
    half of the copies 'inv', second 'lin')."""

    def __init__(self, d_model: int, d_state: int = 64, channels: int = 1,
                 dt_min: float = 1e-3, dt_max: float = 1e-1,
                 kernel_impl: str = "jnp", disc: str = "zoh",
                 n_ssm: Optional[int] = None, dt_tie: bool = True,
                 dt_transform: str = "exp", dt_fast: bool = False,
                 real_transform: str = "exp", imag_transform: str = "none",
                 bandlimit: Optional[float] = None, is_real: bool = False,
                 measure: str = "lin", *, generator=None):
        super().__init__()
        _check_impl(kernel_impl)
        h = d_model
        n_half = d_state if is_real else d_state // 2
        s = n_ssm or h
        if h % s:
            raise ValueError(f"n_ssm={s} must divide d_model={h}")
        if kernel_impl == "pallas":
            if disc != "zoh":
                raise ValueError(
                    f"kernel_impl='pallas' supports disc='zoh' only, got "
                    f"{disc!r}")
            if not (dt_tie and dt_transform == "exp" and not dt_fast
                    and not is_real):
                raise ValueError(
                    "kernel_impl='pallas' supports the default dt "
                    "parameterization (dt_tie=True, dt_transform='exp', "
                    "dt_fast=False) and complex mode only")
        elif disc not in ssm_ops.S4D_KERNELS:
            raise ValueError(f"unknown disc {disc!r}; expected one of "
                             f"{sorted(ssm_ops.S4D_KERNELS)}")
        self.d_model = h
        self.kernel_impl, self.disc = kernel_impl, disc
        self.dt_fast, self.dt_transform = dt_fast, dt_transform
        self.real_transform = real_transform
        self.imag_transform = imag_transform
        self.bandlimit, self.is_real = bandlimit, is_real

        self.log_dt = _dt_init((h,) if dt_tie else (h, n_half), dt_min,
                               dt_max, dt_transform, dt_fast, generator)
        inits = ("inv", "lin") if measure == "diag" else (measure,)
        if s % len(inits):
            raise ValueError(
                f"n_ssm={s} must divide the {len(inits)} inits of "
                f"{measure!r} (models/s4.py:612-616 combination)")
        rows = [ssm_ops.diag_ssm_init(i, n_half) for i in inits]
        rep_i = s // len(inits)
        neg_real, imag_init, b_init = (
            np.concatenate([np.broadcast_to(r[k], (rep_i, n_half))
                            for r in rows], 0) for k in range(3))
        if measure == "lin" and real_transform == "exp":
            la, ai = ssm_ops.s4d_lin_init(s, n_half)  # the f32 log path
        else:
            la = ssm_ops.inv_param_transform(
                neg_real, real_transform).astype(np.float32)
            ai = imag_init.astype(np.float32)
        self.log_A_real = _param(la)
        # a non-constant B folds into the random C (the kernel reads only
        # the product B C), tiled to H like A
        c_shape = (channels, h, n_half) if is_real else (channels, h,
                                                         n_half, 2)
        c = torch.randn(c_shape, generator=generator)
        if not np.allclose(b_init, 1.0):
            bh = np.tile(b_init, (h // s, 1)) if s != h else b_init
            br = torch.as_tensor(bh.real, dtype=torch.float32)
            bi = torch.as_tensor(bh.imag, dtype=torch.float32)
            if is_real:
                c = c * br
            else:
                c = torch.stack([c[..., 0] * br - c[..., 1] * bi,
                                 c[..., 0] * bi + c[..., 1] * br], -1)
        if not is_real:
            if imag_transform != "none":
                ai = ssm_ops.inv_param_transform(
                    ai, imag_transform).astype(np.float32)
            self.A_imag = _param(ai)
        self.C = nn.Parameter(c)

    def forward(self, L: int) -> torch.Tensor:
        h = self.d_model
        a_real = -ssm_ops.param_transform(self.log_A_real,
                                          self.real_transform)
        if self.is_real:
            A = torch.complex(a_real, torch.zeros_like(a_real))
            C = torch.complex(self.C, torch.zeros_like(self.C))
        else:
            im = (self.A_imag if self.imag_transform == "none"
                  else -ssm_ops.param_transform(self.A_imag,
                                                self.imag_transform))
            A = torch.complex(a_real, im)                 # (S, N/2)
            C = torch.view_as_complex(self.C)             # no copy
        if A.shape[0] != h:
            # tying tiles the copies: feature h uses copy h mod S
            A = A.tile(h // A.shape[0], 1)
        if self.bandlimit is not None:
            dt = self._step()
            dt_b = dt[:, None] if dt.ndim == 1 else dt
            freqs = dt_b * A.imag.abs() / (2.0 * math.pi)
            C = C * (freqs < self.bandlimit * 0.5).to(C.real.dtype)
        if self.kernel_impl == "pallas":
            # channels fold into the kernel's rows, which read A and log_dt
            # at row mod H: one launch in all, dt formed in it
            return s4d_kernel_pallas(C, A, self.log_dt, L)
        return ssm_ops.S4D_KERNELS[self.disc](C, A, None, L, dt=self._step())

    def _step(self) -> torch.Tensor:
        inv_dt = torch.sinh(self.log_dt) if self.dt_fast else self.log_dt
        return ssm_ops.param_transform(inv_dt, self.dt_transform)


class DPLRKernelLayer(nn.Module):
    """Full S4 kernel in DPLR form (models/s4.py:1234-1447), the spectrum
    stored at full state size N. ``forward(L)`` returns (channels, H, L).

    measure: HiPPO init, 'legs', 'legt' (rank >= 2), 'fourier'/'fout', or
    the combination 'hippo' (legs + fourier). rank: low-rank correction
    rank (the pallas route: 1). dt_tie False stores dt per (feature,
    conjugate pair), (H, N/2), broadcast to both halves. dt_transform /
    dt_fast / real_transform / bandlimit as in ``S4DKernelLayer``."""

    def __init__(self, d_model: int, d_state: int = 64, channels: int = 1,
                 dt_min: float = 1e-3, dt_max: float = 1e-1,
                 kernel_impl: str = "jnp", rank: int = 1,
                 n_ssm: Optional[int] = None, measure: str = "legs",
                 dt_tie: bool = True, dt_transform: str = "exp",
                 dt_fast: bool = False, real_transform: str = "exp",
                 bandlimit: Optional[float] = None, *, generator=None):
        super().__init__()
        _check_impl(kernel_impl)
        h, n = d_model, d_state
        s = n_ssm or h
        if h % s:
            raise ValueError(f"n_ssm={s} must divide d_model={h}")
        measures = ssm_ops.MEASURE_COMBINATIONS.get(measure, (measure,))
        if s % len(measures):
            raise ValueError(
                f"n_ssm={s} must be a multiple of the {len(measures)} "
                f"measures of {measure!r} (models/s4.py:612-625)")
        if kernel_impl == "pallas":
            if rank != 1:
                raise ValueError("kernel_impl='pallas' supports rank=1 only")
            if not (dt_tie and dt_transform == "exp" and not dt_fast):
                raise ValueError(
                    "kernel_impl='pallas' supports the default dt "
                    "parameterization (dt_tie=True, dt_transform='exp', "
                    "dt_fast=False) only")
        self.d_model, self.d_state, self.channels = h, n, channels
        self.kernel_impl, self.rank = kernel_impl, rank
        self.dt_tie, self.dt_fast, self.dt_transform = dt_tie, dt_fast, \
            dt_transform
        self.real_transform, self.bandlimit = real_transform, bandlimit

        def one_measure(m):
            if m == "legs":
                # the historical legs path; extra rank rows are zero
                lam, p, b, _ = ssm_ops.make_dplr_hippo(n)
                p_rows = np.concatenate(
                    [p[None], np.zeros((rank - 1, n), p.dtype)], axis=0)
                return lam, p_rows, b
            return ssm_ops.nplr_init(m, n, rank)

        # a combination gives each measure a contiguous block of the copies
        parts = [one_measure(m) for m in measures]
        rep_m = s // len(measures)
        lam_s = np.concatenate(
            [np.broadcast_to(lam, (rep_m, n)) for lam, _, _ in parts], 0)
        p_s = np.concatenate(
            [np.broadcast_to(p[:, None], (rank, rep_m, n))
             for _, p, _ in parts], 1)
        b_s = np.concatenate(
            [np.broadcast_to(b, (rep_m, n)) for _, _, b in parts], 0)

        self.log_dt = _dt_init((h,) if dt_tie else (h, n // 2), dt_min,
                               dt_max, dt_transform, dt_fast, generator)
        self.Lambda_log_neg_re = _param(
            ssm_ops.inv_param_transform(-lam_s.real, real_transform))
        self.Lambda_im = _param(lam_s.imag)
        # rank 1 stores (S, N, 2); rank > 1 (R, S, N, 2)
        p_init = p_s[0] if rank == 1 else p_s
        self.P_vec = _param(np.stack([p_init.real, p_init.imag], -1))
        self.B_vec = _param(np.stack([b_s.real, b_s.imag], -1))
        self.C = nn.Parameter(torch.randn((channels, h, n, 2),
                                          generator=generator) * 0.5 ** 0.5)

    def forward(self, L: int) -> torch.Tensor:
        h, n, ch = self.d_model, self.d_state, self.channels
        lam_re = ssm_ops.param_transform(self.Lambda_log_neg_re,
                                         self.real_transform)
        Lambda = torch.complex(-lam_re, self.Lambda_im)       # (S, N)
        P = torch.view_as_complex(self.P_vec)                 # no copies
        B = torch.view_as_complex(self.B_vec)
        if Lambda.shape[0] != h:
            # tied copies tile to the features: feature h uses copy h mod S
            rep = h // Lambda.shape[0]
            Lambda = Lambda.tile(rep, 1)
            B = B.tile(rep, 1)
            P = P.tile(rep, 1) if P.ndim == 2 else P.tile(1, rep, 1)
        C = torch.view_as_complex(self.C)                     # (ch, H, N)
        if self.bandlimit is not None:
            freqs = self._step() * Lambda.imag.abs() / (2.0 * math.pi)
            C = C * (freqs < self.bandlimit * 0.5).to(C.real.dtype)
        if self.kernel_impl == "pallas":
            # channels fold into the Cauchy rows, which read Lambda, P, B
            # and log_dt at row mod H: one launch in all, dt formed in it
            k = dplr_kernel_pallas(Lambda, P, B, C.reshape(ch * h, n),
                                   self.log_dt, L)
            return k.reshape(ch, h, L)
        if P.ndim == 3:
            P = P.movedim(0, 1)                                # (H, R, N)
        return ssm_ops.dplr_kernel(Lambda, P, B, C, None, L, dt=self._step())

    def _step(self) -> torch.Tensor:
        """dt, (H, 1) or (H, N): one per feature, or per state with the
        per-pair dt_tie=False halves repeated."""
        inv_dt = torch.sinh(self.log_dt) if self.dt_fast else self.log_dt
        dt = ssm_ops.param_transform(inv_dt, self.dt_transform)
        if not self.dt_tie:
            dt = torch.cat([dt, dt], dim=-1)  # per pair -> both halves
        return dt[:, None] if dt.ndim == 1 else dt


class FFTConvLayer(nn.Module):
    """FFT convolution around an SSM kernel (models/s4.py:1649-1784):
    x (B, L, H) -> (B, L, channels * H). ``kernel`` is the kernel layer
    (DPLR for mode 'dplr'/'nplr', diagonal otherwise), ``D`` the skip.
    Bidirectional layers pad the forward kernel right and the reversed
    backward kernel left, keeping the reference's off-by-one.
    ``kernel_args`` carries the kernel layer's remaining options; its
    disc, n_ssm and rank win over the fields."""

    def __init__(self, d_model: int, d_state: int = 64, mode: str = "dplr",
                 channels: int = 1, bidirectional: bool = False,
                 activation: Optional[str] = "gelu", dropout: float = 0.0,
                 disc: str = "zoh", n_ssm: Optional[int] = None,
                 rank: int = 1, kernel_impl: str = "jnp",
                 kernel_args: Optional[dict] = None, *, generator=None):
        super().__init__()
        if activation is not None and activation not in ACTIVATIONS_S4:
            raise ValueError(f"unknown activation {activation!r}; expected "
                             f"one of {sorted(ACTIVATIONS_S4)}")
        self.channels, self.bidirectional = channels, bidirectional
        self.activation = activation
        kc = channels * (2 if bidirectional else 1)
        kargs = dict(kernel_args or {})
        disc = kargs.pop("disc", disc)
        n_ssm = kargs.pop("n_ssm", n_ssm)
        rank = kargs.pop("rank", rank)
        if mode in ("dplr", "nplr"):
            self.kernel = DPLRKernelLayer(
                d_model, d_state, channels=kc, rank=rank, n_ssm=n_ssm,
                kernel_impl=kernel_impl, generator=generator, **kargs)
        else:
            self.kernel = S4DKernelLayer(
                d_model, d_state, channels=kc, disc=disc, n_ssm=n_ssm,
                kernel_impl=kernel_impl, generator=generator, **kargs)
        self.D = nn.Parameter(torch.randn((channels, d_model),
                                          generator=generator))
        self.dropout = Dropout(dropout)

    def forward(self, x):
        b, L, h = x.shape
        ch = self.channels
        k = self.kernel(L)                                    # (kc, H, L)
        xt = x.transpose(-1, -2)                              # (B, H, L)
        n = 2 * L
        if self.bidirectional:
            k0, k1 = k[:ch], k[ch:]
            k = (F.pad(k0, (0, L)) + F.pad(torch.flip(k1, (-1,)), (L, 0)))
        kf = torch.fft.rfft(k, n=n, dim=-1)                   # (C, H, nf)
        xf = torch.fft.rfft(xt, n=n, dim=-1)                  # (B, H, nf)
        y = torch.fft.irfft(xf[:, None] * kf[None], n=n, dim=-1)[..., :L]
        y = y + xt[:, None] * self.D[None, :, :, None]        # (B, C, H, L)
        y = y.reshape(b, ch * h, L).transpose(-1, -2)         # (B, L, C*H)
        y = self.dropout(y)
        if self.activation is not None:
            y = ACTIVATIONS_S4[self.activation](y)
        return y


class S4Block(nn.Module):
    """S4Block (models/s4.py:1838-1999): optional bottleneck
    (``input_linear``) and multiplicative gate (``input_gate``,
    ``output_gate``) around the FFTConv (``layer``), then mult_act ->
    dropout -> ``output_linear`` (final_act 'glu' by default)."""

    def __init__(self, d_model: int, d_state: int = 64, mode: str = "dplr",
                 bidirectional: bool = False, dropout: float = 0.0,
                 gate: Optional[int] = None, gate_act: Optional[str] = None,
                 bottleneck: Optional[int] = None,
                 mult_act: Optional[str] = None,
                 final_act: Optional[str] = "glu", disc: str = "zoh",
                 n_ssm: Optional[int] = None, rank: int = 1,
                 kernel_impl: str = "jnp",
                 kernel_args: Optional[dict] = None, *, generator=None):
        super().__init__()
        g = generator
        self.d_model = d_model
        self.gate, self.gate_act, self.bottleneck = gate, gate_act, bottleneck
        self.mult_act, self.final_act = mult_act, final_act
        d_inner = d_model // bottleneck if bottleneck else d_model
        if gate:
            self.input_gate = dense(d_model, d_inner * gate, g)
        if bottleneck:
            self.input_linear = dense(d_model, d_inner, g)
        self.layer = FFTConvLayer(
            d_inner, d_state, mode, channels=1, bidirectional=bidirectional,
            dropout=dropout, disc=disc, n_ssm=n_ssm, rank=rank,
            kernel_impl=kernel_impl, kernel_args=kernel_args, generator=g)
        d_out = d_inner
        if gate:
            if d_inner != d_inner * gate:
                self.output_gate = dense(d_inner, d_inner * gate, g)
            d_out = d_inner * gate
        self.dropout = Dropout(dropout)
        if final_act is not None:
            width = 2 * d_model if final_act == "glu" else d_model
            self.output_linear = dense(d_out, width, g)

    def forward(self, x):
        if self.gate:
            v = self.input_gate(x)
            if self.gate_act:
                v = ACTIVATIONS_S4[self.gate_act](v)
        if self.bottleneck:
            x = self.input_linear(x)
        y = self.layer(x)
        if self.gate:
            if hasattr(self, "output_gate"):
                y = self.output_gate(y)
            y = y * v
        if self.mult_act:
            y = ACTIVATIONS_S4[self.mult_act](y)
        y = self.dropout(y)
        if self.final_act is None:
            return y
        y = self.output_linear(y)
        if self.final_act == "glu":
            return y[..., :self.d_model] * torch.sigmoid(y[..., self.d_model:])
        return ACTIVATIONS_S4[self.final_act](y)


class S4D(nn.Module):
    """Standalone S4D layer (models/s4d.py:84-129), channels-last: a
    diagonal FFTConv (``layer``) and a GLU (``output_linear``)."""

    def __init__(self, d_model: int, d_state: int = 64, dropout: float = 0.0,
                 *, generator=None):
        super().__init__()
        self.d_model = d_model
        self.layer = FFTConvLayer(d_model, d_state, mode="diag",
                                  dropout=dropout, generator=generator)
        self.output_linear = dense(d_model, 2 * d_model, generator)

    def forward(self, x):
        y = self.output_linear(self.layer(x))
        return y[..., :self.d_model] * torch.sigmoid(y[..., self.d_model:])


class S4Model(nn.Module):
    """1D S4 PDE model (models/s4_1d.py:7-185): (B, d_input, L) ->
    (B, d_output, L). The encoder reads d_input + 1 channels (the grid
    concat); the layers are bidirectional S4Blocks with residuals. With
    prenorm False (the shipped configs) no norm is applied, as in the
    reference, whose post-norm result is discarded (s4_1d.py:115-117);
    with prenorm True a LayerNorm (flax's eps 1e-6) precedes each block.
    Parameters are drawn from ``generator`` on the CPU, then moved to
    ``device``."""

    def __init__(self, d_input: int = 1, d_output: int = 1,
                 d_model: int = 256, n_layers: int = 4, dropout: float = 0.2,
                 prenorm: bool = False, mode: str = "dplr",
                 kernel_impl: str = "jnp", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.prenorm = prenorm
        self.encoder = dense(d_input + 1, d_model, g)
        if prenorm:
            self.norms = nn.ModuleList([nn.LayerNorm(d_model, eps=1e-6)
                                        for _ in range(n_layers)])
        self.s4_layers = nn.ModuleList([
            S4Block(d_model, mode=mode, bidirectional=True, dropout=dropout,
                    kernel_impl=kernel_impl, generator=g)
            for _ in range(n_layers)])
        self.dropouts = nn.ModuleList([Dropout(dropout)
                                       for _ in range(n_layers)])
        self.decoder = dense(d_model, d_output, g)
        if device is not None:
            self.to(device)

    def forward(self, x):
        x = concat_grid_1d(x.transpose(-1, -2), 0.0, 1.0)    # (B, L, d_in+1)
        x = self.encoder(x)
        for i, block in enumerate(self.s4_layers):
            z = self.norms[i](x) if self.prenorm else x
            x = self.dropouts[i](block(z)) + x
        return self.decoder(x).transpose(-1, -2)


class S4NDLayer(nn.Module):
    """N-d S4ND layer (models/s4nd.py:1815-2100): one SSM kernel per spatial
    axis, combined as an outer product in frequency space, then an N-d FFT
    convolution. Channels-last: x (B, *spatial, d_model) -> the same shape.

    The spatial rank is the input's. Torch parameters exist before the
    first call, so the layer holds ``ndim`` kernels (default 2) and an
    input of another rank raises. 2D kernels are named ``kernel_x`` (axis
    0) and ``kernel_y`` (axis 1), other ranks ``kernel_ax{i}``, as in JAX.
    mode: 'diag' (S4D kernels) or 'dplr'/'nplr' (full S4 kernels).
    kernel_args: the kernel layers' options, passed to them as they are
    (``kernel_impl='pallas'`` reaches the hand kernels this way).
    bidirectional: a two-sided kernel per axis (two kernel channels).
    linear: conv + D skip only (the reference's default); otherwise
    dropout, GELU and a GLU (``output_linear``, Dense 2 d_model) follow.
    D is drawn as a standard normal."""

    def __init__(self, d_model: int, d_state: int = 64,
                 bidirectional: bool = False, dropout: float = 0.0,
                 mode: str = "diag", linear: bool = False,
                 kernel_args: Optional[dict] = None, ndim: int = 2, *,
                 generator=None):
        super().__init__()
        if ndim < 1:
            raise ValueError(f"S4NDLayer needs at least one spatial axis, "
                             f"got ndim={ndim}")
        g = generator
        self.d_model, self.ndim = d_model, ndim
        self.bidirectional, self.linear = bidirectional, linear
        kc = 2 if bidirectional else 1
        kernel_cls = (DPLRKernelLayer if mode in ("dplr", "nplr")
                      else S4DKernelLayer)
        self.kernel_names = (["kernel_x", "kernel_y"] if ndim == 2
                             else [f"kernel_ax{i}" for i in range(ndim)])
        for name in self.kernel_names:
            self.add_module(name, kernel_cls(d_model, d_state, channels=kc,
                                             generator=g,
                                             **(kernel_args or {})))
        self.D = nn.Parameter(torch.randn((d_model,), generator=g))
        if not linear:
            self.dropout = Dropout(dropout)
            self.output_linear = dense(d_model, 2 * d_model, g)

    def _two_sided(self, k, L: int):
        if not self.bidirectional:
            return k[0]                                   # (C, L)
        return F.pad(k[0], (0, L)) + F.pad(torch.flip(k[1], (-1,)), (L, 0))

    def forward(self, x):
        spatial = tuple(x.shape[1:-1])
        ndim, c = len(spatial), x.shape[-1]
        if ndim != self.ndim:
            raise ValueError(
                f"S4NDLayer with ndim={self.ndim} got a (B, *spatial, C) "
                f"input of {ndim} spatial axes, shape {tuple(x.shape)}")
        ns = [2 * L for L in spatial]
        dims = tuple(range(2, 2 + ndim))
        xt = x.movedim(-1, 1)                             # (B, C, *spatial)
        xf = torch.fft.rfftn(xt, s=ns, dim=dims)
        # the kernels' spectra as an outer product: the full FFT on every
        # axis but the last, the real FFT on the last (as rfftn)
        kf = None
        for i, (name, L) in enumerate(zip(self.kernel_names, spatial)):
            k = self._two_sided(getattr(self, name)(L), L)
            fft = torch.fft.rfft if i == ndim - 1 else torch.fft.fft
            kfi = fft(k, n=ns[i], dim=-1)
            shape = [c] + [1] * ndim
            shape[1 + i] = kfi.shape[-1]
            kfi = kfi.reshape(shape)
            kf = kfi if kf is None else kf * kfi
        # the product's DC and Nyquist bins along the last axis are complex:
        # irfftn reads them as real, as numpy and JAX do
        y = irfftn(xf * kf[None], ns, dim=dims)
        y = y[(Ellipsis,) + tuple(slice(0, L) for L in spatial)]
        y = y + xt * self.D.reshape((1, c) + (1,) * ndim)
        y = y.movedim(1, -1)
        if self.linear:
            return y
        y = self.output_linear(gelu(self.dropout(y)))
        return y[..., :self.d_model] * torch.sigmoid(y[..., self.d_model:])


class S4ND2dLayer(S4NDLayer):
    """The 2D S4NDLayer (the name of JAX's, kept for configs)."""


class S4NDModel(nn.Module):
    """2D S4ND PDE model (models/s4_2d.py:8-160): (B, d_input, H, W) ->
    (B, d_output, H, W). The grid concat adds 2 channels and a Dense
    (``encoder``) lifts to d_model; each layer is an S4ND2dLayer
    (``s4_layers.{i}``) with dropout and a residual, post-normed by a
    LayerNorm (``norms.{i}``, flax's eps 1e-6), or pre-normed with
    prenorm True; a Dense (``decoder``) projects.

    Input width: JAX infers the encoder's from the input and never reads
    d_input (the shipped yaml's d_input 15 is unused); the port sizes it
    from d_input + 2, as its S4Model does from d_input + 1, and raises a
    ValueError naming both numbers when the input has another channel
    count. kernel_impl is forwarded to the layers' kernels ('pallas': the
    hand kernels, forward-only; the same function as 'jnp'). Parameters
    are drawn from ``generator`` on the CPU, then moved to ``device``."""

    def __init__(self, d_input: int = 1, d_output: int = 1,
                 d_model: int = 256, n_layers: int = 4, dropout: float = 0.2,
                 bidirectional: bool = False, prenorm: bool = False,
                 mode: str = "diag", s4nd_linear: bool = False,
                 kernel_impl: str = "jnp", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_impl(kernel_impl)
        g = generator
        self.d_input, self.prenorm = d_input, prenorm
        self.encoder = dense(d_input + 2, d_model, g)
        self.s4_layers = nn.ModuleList([
            S4ND2dLayer(d_model, bidirectional=bidirectional,
                        dropout=dropout, mode=mode, linear=s4nd_linear,
                        kernel_args=dict(kernel_impl=kernel_impl),
                        generator=g)
            for _ in range(n_layers)])
        self.dropouts = nn.ModuleList([Dropout(dropout)
                                       for _ in range(n_layers)])
        self.norms = nn.ModuleList([nn.LayerNorm(d_model, eps=1e-6)
                                    for _ in range(n_layers)])
        self.decoder = dense(d_model, d_output, g)
        if device is not None:
            self.to(device)

    def forward(self, x):
        if x.shape[1] != self.d_input:
            raise ValueError(
                f"S4NDModel(d_input={self.d_input}) got {x.shape[1]} input "
                f"channels: its encoder reads d_input + 2 = "
                f"{self.d_input + 2} (the input and the 2 grid channels)")
        x = self.encoder(concat_grid_2d(x.movedim(1, -1), 0.0, 1.0))
        for layer, drop, norm in zip(self.s4_layers, self.dropouts,
                                     self.norms):
            z = norm(x) if self.prenorm else x
            x = drop(layer(z)) + x
            if not self.prenorm:
                x = norm(x)
        return self.decoder(x).movedim(-1, 1)


# ---------------------------------------------------------------------------
# Recurrent step functions (models/s4.py:744-874)
# ---------------------------------------------------------------------------

def _kernel_params(kernel) -> dict:
    """A kernel layer's parameters by their JAX names: the module's
    state_dict (detached), or a state_dict as it is."""
    return kernel.state_dict() if isinstance(kernel, nn.Module) else kernel


def _resolve_dt(kernel_params, dt_transform: str, dt_fast: bool):
    """The stored dt parameter as positive timesteps, as the kernel layers
    resolve it: (H,), or (H, n) per state (dt_tie False)."""
    log_dt = kernel_params["log_dt"]
    inv_dt = torch.sinh(log_dt) if dt_fast else log_dt
    return ssm_ops.param_transform(inv_dt, dt_transform)


def s4d_recurrent_step_fn(kernel, L_unused=None, disc: str = "zoh", *,
                          dt_transform: str = "exp", dt_fast: bool = False,
                          real_transform: str = "exp",
                          imag_transform: str = "none",
                          is_real: bool = False, bandlimit=None):
    """The recurrent form of an ``S4DKernelLayer`` (the module, or its
    state_dict), its channel 0 (models/s4.py:1787-1807 _setup_step/step).

    disc: 'zoh' | 'bilinear' ('dss' has no recurrent form). The keyword
    options must be the layer's; dt_tie False is read from the stored dt's
    shape, n_ssm ties from A's. Returns (init_state(batch) -> (batch, H,
    N/2) complex64 zeros on the parameters' device, step(state, u (B, H))
    -> (state, y (B, H))), y = 2 Re sum_n C x."""
    p = _kernel_params(kernel)
    dt = _resolve_dt(p, dt_transform, dt_fast)
    a_real = -ssm_ops.param_transform(p["log_A_real"], real_transform)
    c = p["C"][0]
    if is_real:
        A = torch.complex(a_real, torch.zeros_like(a_real))
        C = torch.complex(c, torch.zeros_like(c))
    else:
        a_imag = p["A_imag"]
        im = (a_imag if imag_transform == "none"
              else -ssm_ops.param_transform(a_imag, imag_transform))
        A = torch.complex(a_real, im)
        C = torch.view_as_complex(c.contiguous())
    if A.shape[0] != C.shape[0]:  # n_ssm-tied copies, tiled
        A = A.tile(C.shape[0] // A.shape[0], 1)
    dt_cols = dt[:, None] if dt.ndim == 1 else dt
    if bandlimit is not None:
        freqs = dt_cols * A.imag.abs() / (2.0 * math.pi)
        C = C * (freqs < bandlimit * 0.5).to(C.real.dtype)
    if disc == "zoh":
        Ab, dB = ssm_ops.discretize_diag_zoh(A, None, dt=dt_cols)
    elif disc == "bilinear":
        Ab, dB = ssm_ops.discretize_diag_bilinear(A, None, dt=dt_cols)
    else:
        raise ValueError(f"no recurrent form for disc={disc!r} (the "
                         "reference has zoh and bilinear, "
                         "models/s4.py:1196-1206)")
    h, n_half = A.shape

    def init_state(batch: int):
        return torch.zeros((batch, h, n_half), dtype=torch.complex64,
                           device=A.device)

    def step(state, u):
        """state (B, H, N/2); u (B, H) -> (new_state, y (B, H))."""
        new_state = Ab * state + dB * u[..., None]
        return new_state, 2.0 * (C * new_state).sum(-1).real

    return init_state, step


def dplr_recurrent_step_fn(kernel, L: int, *, dt_transform: str = "exp",
                           dt_fast: bool = False,
                           real_transform: str = "exp", bandlimit=None):
    """The recurrent form of a ``DPLRKernelLayer`` (the module, or its
    state_dict), its channel 0 (models/s4.py:1190-1218, 1787-1807). L is
    the kernel length the layer was trained at (the stepping C inverts
    I - Abar^L, ``ops.ssm.discretize_dplr``). The keyword options must be
    the layer's; dt_tie False ((H, N/2) per conjugate pair) is read from
    the stored dt's shape and repeated over both halves, as the
    convolution does. Returns (init_state(batch) -> (batch, H, N) complex
    zeros, step(state, u (B, H)) -> (state, y (B, H))), y = Re(C^* x)."""
    p = _kernel_params(kernel)
    dt = _resolve_dt(p, dt_transform, dt_fast)            # (H,) | (H, N/2)
    Lam = torch.complex(
        -ssm_ops.param_transform(p["Lambda_log_neg_re"], real_transform),
        p["Lambda_im"])                                   # (S, N)
    P = torch.view_as_complex(p["P_vec"].contiguous())    # (S,N) | (R,S,N)
    B = torch.view_as_complex(p["B_vec"].contiguous())
    C_t = torch.view_as_complex(p["C"][0].contiguous())   # (H, N)
    if Lam.shape[0] != C_t.shape[0]:  # n_ssm-tied copies, tiled
        rep = C_t.shape[0] // Lam.shape[0]
        Lam, B = Lam.tile(rep, 1), B.tile(rep, 1)
        P = P.tile(rep, 1) if P.ndim == 2 else P.tile(1, rep, 1)
    if dt.ndim == 2:
        dt = torch.cat([dt, dt], dim=-1)                  # (H, N)
    dt_b = dt[:, None] if dt.ndim == 1 else dt
    if bandlimit is not None:
        # masks the trained C~ before the stepping C is recovered
        freqs = dt_b * Lam.imag.abs() / (2.0 * math.pi)
        C_t = C_t * (freqs < bandlimit * 0.5).to(C_t.real.dtype)
    if P.ndim == 3:
        P = P.movedim(0, 1)                               # (H, R, N)
    Ab, Bb, C = ssm_ops.discretize_dplr(Lam, P, B, C_t, None, L, dt=dt_b)
    h, n = Lam.shape
    C_conj = torch.conj_physical(C)

    def init_state(batch: int):
        return torch.zeros((batch, h, n), dtype=Ab.dtype, device=Ab.device)

    def step(state, u):
        """state (B, H, N); u (B, H) -> (new_state, y (B, H))."""
        new_state = (torch.einsum("hij,bhj->bhi", Ab, state)
                     + Bb * u[..., None])
        return new_state, (C_conj * new_state).sum(-1).real

    return init_state, step
