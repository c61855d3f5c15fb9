"""FFNO 2D: factorized Fourier neural operator with resolution-adaptive
mode slicing, so one weight set serves every grid size.

Counterpart of resolution_pde_tpu/models/ffno.py (``FSpectralConv2d``,
``FFNO2D``). Layout: (B, C, H, W) at the model boundary, channels-last
(B, H, W, C) inside. ``spectral_impl`` selects the spectral pass:
  - 'fft':     torch.fft, f32 (the plain reference);
  - 'pallas':  the fused spectral kernel in f32 (the f32-exact mode);
  - 'pallas2': the fused spectral kernel in ``compute_dtype``.
The names are the JAX package's, so one config selects the counterpart.
"""

from __future__ import annotations

import torch
from torch import nn

from resolution_pde_tpu_torch.models.layers import (FeedForward, WNDense,
                                                    xavier_normal_init)
from resolution_pde_tpu_torch.ops.grids import concat_grid_2d
from resolution_pde_tpu_torch.ops.kernels.spectral_mix import (
    factorized_spectral_conv_2d_pallas2)
from resolution_pde_tpu_torch.ops.spectral import (
    factorized_spectral_conv_2d, factorized_spectral_conv_2d_pallas)

SPECTRAL_IMPLS = ("fft", "pallas", "pallas2")


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
            if self.spectral_impl == "pallas2":
                xin = x if self.compute_dtype is not None else x.float()
                x = factorized_spectral_conv_2d_pallas2(
                    xin, wy, wx, self.n_modes,
                    compute_dtype=self.compute_dtype).to(dt)
            elif self.spectral_impl == "pallas":
                x = factorized_spectral_conv_2d_pallas(
                    x.float(), wy, wx, self.n_modes).to(dt)
            else:
                x = factorized_spectral_conv_2d(
                    x.float(), wy, wx, self.n_modes).to(dt)
        return self.backcast_ff(x, residual=residual)


class FFNO2D(nn.Module):
    """2D FFNO. Input (B, C_in, H, W) -> (B, C_out, H, W), in the input's
    dtype. The grid concat is linspace(0, 1) per axis; the in/out
    projections are weight-normed when ``ff_weight_norm``. Parameters are
    drawn from ``generator`` on the CPU and then moved to ``device``."""

    def __init__(self, in_channels: int, out_channels: int, width: int = 64,
                 n_layers: int = 4, n_modes: int = 16, factor: int = 4,
                 ff_weight_norm: bool = False, n_ff_layers: int = 2,
                 layer_norm: bool = False, dropout: float = 0.0,
                 mode: str = "full", use_grid: bool = True,
                 compute_dtype=None, spectral_impl: str = "fft",
                 approx_gelu: bool = False, ff_impl: str = "dense", *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.use_grid = use_grid
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
        for layer in self.fourier_layers:
            if layer.backcast_ff.fused:
                x = layer(x, residual=x)  # residual add inside the kernel
            else:
                x = x + layer(x)
        x = self.out_proj(x)
        return x.permute(0, 3, 1, 2).to(in_dtype)
