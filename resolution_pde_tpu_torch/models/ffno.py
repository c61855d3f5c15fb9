"""FFNO 1D and 2D: factorized Fourier neural operators with
resolution-adaptive mode slicing, so one weight set serves every grid size.

Counterpart of resolution_pde_tpu/models/ffno.py (``FSpectralConv1d``,
``FFNO1D``, ``FSpectralConv2d``, ``FFNO2D``). Layout: (B, C, X) or
(B, C, H, W) at the model boundary, channels-last inside. FFNO1D runs its
spectral pass through torch.fft in f32, as the JAX package does; its
FeedForward runs the fused kernels with ``ff_impl='fused'`` at dropout 0.
FFNO2D's ``spectral_impl`` selects its spectral pass:
  - 'fft':     torch.fft, f32 (the plain reference);
  - 'pallas':  the spectral kernel in f32 (the f32-exact mode);
  - 'pallas2': the spectral kernels in ``compute_dtype`` (bf16: the staged
    route).
The names are the JAX package's, so one config selects the counterpart.
FFNO2D runs on the slabs of a grid sharded over "spatial" inside
``parallel.spatial.sharded`` (``spatial_sharding``), each route with its
H pass on pencils.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from resolution_pde_tpu_torch.models.layers import (ACTIVATIONS, Dropout,
                                                    FeedForward, WNDense,
                                                    xavier_normal_init)
from resolution_pde_tpu_torch.ops.grids import concat_grid_1d, concat_grid_2d
from resolution_pde_tpu_torch.ops.kernels.spectral_mix import (
    factorized_spectral_conv_2d_pallas2,
    factorized_spectral_conv_2d_pallas2_slabs)
from resolution_pde_tpu_torch.ops.spectral import (
    factorized_spectral_conv_1d, factorized_spectral_conv_2d,
    factorized_spectral_conv_2d_pallas, factorized_spectral_conv_2d_slabs,
    truncate_modes_1d)
from resolution_pde_tpu_torch.parallel import spatial

SPECTRAL_IMPLS = ("fft", "pallas", "pallas2")
MODES_1D = ("full", "low-pass", "no-fourier")


class FSpectralConv1d(nn.Module):
    """FFNO 1D layer: factorized spectral conv, then the FeedForward, then
    ``activation``. mode 'full' mixes the kept modes with
    ``fourier_weight[0]``, 'low-pass' only truncates them, 'no-fourier'
    skips the spectral pass. The residual add stays outside the layer."""

    def __init__(self, d_model: int, n_modes: int, factor: int = 4,
                 ff_weight_norm: bool = False, n_ff_layers: int = 2,
                 layer_norm: bool = False, dropout: float = 0.0,
                 mode: str = "full", fft_norm: str = "ortho",
                 activation: str = "identity", ff_impl: str = "dense",
                 generator=None):
        super().__init__()
        if mode not in MODES_1D:
            raise ValueError(f"unknown mode {mode!r}; supported: "
                             f"{', '.join(MODES_1D)}")
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.n_modes = n_modes
        self.mode = mode
        self.fft_norm = fft_norm
        self.activation = activation
        if mode == "full":
            self.fourier_weight = nn.ParameterList([nn.Parameter(
                xavier_normal_init((d_model, d_model, n_modes, 2),
                                   generator))])
        self.backcast_ff = FeedForward(
            d_model, factor, n_ff_layers, ff_weight_norm, layer_norm,
            dropout, ff_impl=ff_impl, generator=generator)

    def forward(self, x):
        """x: (B, X, C) -> (B, X, C)."""
        if self.mode == "full":
            x = factorized_spectral_conv_1d(x, self.fourier_weight[0],
                                            self.n_modes, self.fft_norm)
        elif self.mode == "low-pass":
            x = truncate_modes_1d(x, self.n_modes, self.fft_norm)
        return ACTIVATIONS[self.activation](self.backcast_ff(x))


class FFNO1D(nn.Module):
    """1D FFNO. Input (B, C_in, X) -> (B, C_out, X). ``use_grid`` appends a
    linspace(0, 1) channel as named (the yaml sets it false, the
    reference's effective behaviour). Parameters are drawn from
    ``generator`` on the CPU and then moved to ``device``."""

    def __init__(self, in_channels: int, out_channels: int, width: int = 64,
                 n_layers: int = 4, n_modes: int = 16, factor: int = 4,
                 ff_weight_norm: bool = False, n_ff_layers: int = 2,
                 layer_norm: bool = False, dropout: float = 0.0,
                 mode: str = "full", fft_norm: str = "ortho",
                 activation: str = "identity", use_grid: bool = False,
                 ff_impl: str = "dense", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_grid = use_grid
        g = generator
        self.in_proj = WNDense(in_channels + (1 if use_grid else 0), width,
                               wnorm=ff_weight_norm, generator=g)
        self.fourier_layers = nn.ModuleList([
            FSpectralConv1d(width, n_modes, factor, ff_weight_norm,
                            n_ff_layers, layer_norm, dropout, mode, fft_norm,
                            activation, ff_impl, generator=g)
            for _ in range(n_layers)])
        self.out_proj = WNDense(width, out_channels, wnorm=ff_weight_norm,
                                generator=g)
        if device is not None:
            self.to(device)

    def forward(self, x):
        x = x.transpose(1, 2)  # (B, X, C)
        if self.use_grid:
            x = concat_grid_1d(x, 0.0, 1.0)
        x = self.in_proj(x)
        for layer in self.fourier_layers:
            x = x + layer(x)
        return self.out_proj(x).transpose(1, 2)


class FSpectralConv2d(nn.Module):
    """FFNO 2D layer: factorized spectral conv, then the FeedForward.

    ``fourier_weight[0]`` is the reference's weight_y, applied along W (the
    last spatial axis); ``fourier_weight[1]`` is weight_x, applied along H.
    In bf16 mode (``compute_dtype`` set) 'pallas2' takes x as it is; the f32
    paths upcast it first. mode 'no-fourier' skips the spectral pass.
    """

    def __init__(self, d_model: int, n_modes: int, factor: int = 4,
                 ff_weight_norm: bool = False, n_ff_layers: int = 2,
                 layer_norm: bool = False, dropout: float = 0.0,
                 mode: str = "full", compute_dtype=None,
                 spectral_impl: str = "fft", approx_gelu: bool = False,
                 ff_impl: str = "dense", generator=None):
        super().__init__()
        if spectral_impl not in SPECTRAL_IMPLS:
            raise ValueError(f"unknown spectral_impl {spectral_impl!r}; "
                             f"supported: {', '.join(SPECTRAL_IMPLS)}")
        if mode not in ("full", "no-fourier"):
            raise ValueError(f"unsupported 2D mode {mode!r}")
        self.n_modes = n_modes
        self.mode = mode
        self.compute_dtype = compute_dtype
        self.spectral_impl = spectral_impl
        if mode == "full":
            shape = (d_model, d_model, n_modes, 2)
            self.fourier_weight = nn.ParameterList(
                [nn.Parameter(xavier_normal_init(shape, generator))
                 for _ in range(2)])
        self.backcast_ff = FeedForward(
            d_model, factor, n_ff_layers, ff_weight_norm, layer_norm,
            dropout, dtype=compute_dtype, approx_gelu=approx_gelu,
            ff_impl=ff_impl, generator=generator)

    def forward(self, x, residual=None):
        """x: (B, H, W, C) -> (B, H, W, C); ``residual`` is added to the
        output (inside the fused kernel when the FeedForward is fused)."""
        if self.mode == "full":
            wy, wx = self.fourier_weight
            dt = x.dtype
            shard = spatial.active()
            if self.spectral_impl in ("pallas", "pallas2") and shard:
                pallas2 = self.spectral_impl == "pallas2"
                cd = self.compute_dtype if pallas2 else torch.float32
                xin = x if pallas2 and cd is not None else x.float()
                x = factorized_spectral_conv_2d_pallas2_slabs(
                    xin, wy, wx, self.n_modes, shard,
                    compute_dtype=cd).to(dt)
            elif self.spectral_impl == "pallas2":
                xin = x if self.compute_dtype is not None else x.float()
                x = factorized_spectral_conv_2d_pallas2(
                    xin, wy, wx, self.n_modes,
                    compute_dtype=self.compute_dtype).to(dt)
            elif self.spectral_impl == "pallas":
                x = factorized_spectral_conv_2d_pallas(
                    x.float(), wy, wx, self.n_modes).to(dt)
            elif shard:
                x = factorized_spectral_conv_2d_slabs(
                    x.float(), wy, wx, self.n_modes, shard).to(dt)
            else:
                x = factorized_spectral_conv_2d(
                    x.float(), wy, wx, self.n_modes).to(dt)
        return self.backcast_ff(x, residual=residual)


@contextlib.contextmanager
def _replay(generators, states):
    """Run the block with each generator at its recorded state, then put
    every generator back where it was."""
    now = [g.get_state() for g in generators]
    for g, s in zip(generators, states):
        g.set_state(s)
    try:
        yield
    finally:
        for g, s in zip(generators, now):
            g.set_state(s)


def _remat(layer, x, residual):
    """``layer(x, residual=...)`` under activation checkpointing: its
    activations are dropped after the forward and recomputed in the
    backward. The recompute draws the same dropout masks, since every
    dropout generator of the layer is replayed from its state at the
    forward (torch.utils.checkpoint replays only torch's default ones)."""
    gens = list({id(m.generator): m.generator for m in layer.modules()
                 if isinstance(m, Dropout) and m.generator is not None
                 }.values())
    states = [g.get_state() for g in gens]
    return checkpoint(
        lambda a, r: layer(a, residual=r), x, residual, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _replay(gens, states)))


class FFNO2D(nn.Module):
    """2D FFNO. Input (B, C_in, H, W) -> (B, C_out, H, W), in the input's
    dtype. The grid concat is linspace(0, 1) per axis; the in/out
    projections are weight-normed when ``ff_weight_norm``. Parameters are
    drawn from ``generator`` on the CPU and then moved to ``device``.
    ``remat`` recomputes each Fourier layer's activations in the backward
    instead of keeping them (the JAX package's ``nn.remat`` per layer)."""

    spatial_sharding = True  # runs on the slabs of parallel/spatial.py

    def __init__(self, in_channels: int, out_channels: int, width: int = 64,
                 n_layers: int = 4, n_modes: int = 16, factor: int = 4,
                 ff_weight_norm: bool = False, n_ff_layers: int = 2,
                 layer_norm: bool = False, dropout: float = 0.0,
                 mode: str = "full", use_grid: bool = True,
                 remat: bool = False, compute_dtype=None,
                 spectral_impl: str = "fft", approx_gelu: bool = False,
                 ff_impl: str = "dense", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_grid = use_grid
        self.remat = remat
        self.compute_dtype = compute_dtype
        g = generator
        self.in_proj = WNDense(in_channels + (2 if use_grid else 0), width,
                               wnorm=ff_weight_norm, dtype=compute_dtype,
                               generator=g)
        self.fourier_layers = nn.ModuleList([
            FSpectralConv2d(width, n_modes, factor, ff_weight_norm,
                            n_ff_layers, layer_norm, dropout, mode,
                            compute_dtype, spectral_impl, approx_gelu,
                            ff_impl, generator=g)
            for _ in range(n_layers)])
        self.out_proj = WNDense(width, out_channels, wnorm=ff_weight_norm,
                                dtype=compute_dtype, generator=g)
        if device is not None:
            self.to(device)

    def forward(self, x):
        in_dtype = x.dtype
        x = x.permute(0, 2, 3, 1)  # (B, H, W, C)
        if self.use_grid:
            x = concat_grid_2d(x, 0.0, 1.0)
        x = self.in_proj(x)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.fourier_layers:
            # the residual add runs inside the kernel when the FF is fused
            residual = x if layer.backcast_ff.fused else None
            y = _remat(layer, x, residual) if remat else layer(x, residual)
            x = y if residual is not None else x + y
        x = self.out_proj(x)
        return x.permute(0, 3, 1, 2).to(in_dtype)
