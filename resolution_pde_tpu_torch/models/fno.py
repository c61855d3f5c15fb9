"""FNO 1D and 2D: the classic Fourier neural operator.

Counterpart of resolution_pde_tpu/models/fno.py (reference models/fno.py
and models/fno_blocks.py): a coordinate channel appended to the input, a
pointwise lift to ``width``, ``n_blocks`` blocks of activation(spectral
conv + pointwise bypass), and a pointwise MLP projection. Layout: (B, C, X)
or (B, C, H, W) at the model boundary, channels-last inside. The
parameters carry the reference's names (``lifting``,
``fno_blocks.{i}.spectral_conv.weights1`` / ``weights2``,
``fno_blocks.{i}.bypass_conv``, ``projection.mlp1`` / ``mlp2``); the
spectral weights are real with a trailing (re, im) axis, each component
drawn U(0, 1 / (C_in C_out)) as the reference's ``scale * torch.rand``.
The spectral convs run through torch.fft in f32: no hand kernel (the JAX
package's is an einsum too). Parameters are drawn from ``generator`` on
the CPU and then moved to ``device``. FNO2d runs on the slabs of a grid
sharded over "spatial" inside ``parallel.spatial.sharded``
(``spatial_sharding``; its H transform a partial DFT over each rank's
rows).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from resolution_pde_tpu_torch.models.layers import (ACTIVATIONS,
                                                    PointwiseMLP,
                                                    TorchLinear)
from resolution_pde_tpu_torch.ops.grids import concat_grid_1d, concat_grid_2d
from resolution_pde_tpu_torch.ops.spectral import (spectral_conv_1d,
                                                   spectral_conv_2d,
                                                   spectral_conv_2d_slabs)
from resolution_pde_tpu_torch.parallel import spatial


def _fno_weight(shape, generator=None) -> nn.Parameter:
    """scale * U(0, 1) per component, scale = 1 / (C_in C_out)."""
    return nn.Parameter(torch.rand(shape, generator=generator)
                        / (shape[0] * shape[1]))


class SpectralConv1dLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, modes: int,
                 generator=None):
        super().__init__()
        self.modes = modes
        self.weights1 = _fno_weight((in_channels, out_channels, modes, 2),
                                    generator)

    def forward(self, x):
        """x: (B, X, C_in) -> (B, X, C_out)."""
        return spectral_conv_1d(x.transpose(-1, -2), self.weights1,
                                self.modes).transpose(-1, -2)


class SpectralConv2dLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, modes1: int,
                 modes2: int, generator=None):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        shape = (in_channels, out_channels, modes1, modes2, 2)
        self.weights1 = _fno_weight(shape, generator)
        self.weights2 = _fno_weight(shape, generator)

    def forward(self, x):
        """x: (B, H, W, C_in) -> (B, H, W, C_out); a slab of a grid sharded
        over "spatial" inside ``parallel.spatial.sharded``."""
        shard = spatial.active()
        args = (x.permute(0, 3, 1, 2), self.weights1, self.weights2,
                self.modes1, self.modes2)
        out = (spectral_conv_2d_slabs(*args, shard) if shard
               else spectral_conv_2d(*args))
        return out.permute(0, 2, 3, 1)


class FNOBlock1d(nn.Module):
    """activation(spectral_conv(x) + bypass_conv(x))."""

    def __init__(self, width: int, modes: int, activation: str = "relu",
                 generator=None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.spectral_conv = SpectralConv1dLayer(width, width, modes,
                                                 generator)
        self.bypass_conv = TorchLinear(width, width, generator=generator)

    def forward(self, x):
        return ACTIVATIONS[self.activation](self.spectral_conv(x)
                                            + self.bypass_conv(x))


class FNOBlock2d(nn.Module):
    def __init__(self, width: int, modes1: int, modes2: int,
                 activation: str = "gelu", generator=None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.spectral_conv = SpectralConv2dLayer(width, width, modes1,
                                                 modes2, generator)
        self.bypass_conv = TorchLinear(width, width, generator=generator)

    def forward(self, x):
        return ACTIVATIONS[self.activation](self.spectral_conv(x)
                                            + self.bypass_conv(x))


class FNO1d(nn.Module):
    """1D FNO. Input (B, C_in, X) -> (B, C_out, X); the grid channel is
    linspace(0, 2 pi, X)."""

    def __init__(self, in_channels: int, out_channels: int, modes: int,
                 width: int, n_blocks: int = 4, activation: str = "relu",
                 *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.lifting = TorchLinear(in_channels + 1, width, generator=g)
        self.fno_blocks = nn.ModuleList([
            FNOBlock1d(width, modes, activation, generator=g)
            for _ in range(n_blocks)])
        self.projection = PointwiseMLP(width, out_channels, width * 4,
                                       generator=g)
        if device is not None:
            self.to(device)

    def forward(self, x):
        x = concat_grid_1d(x.transpose(1, 2), 0.0, 2.0 * math.pi)
        x = self.lifting(x)
        for block in self.fno_blocks:
            x = block(x)
        return self.projection(x).transpose(1, 2)


class FNO2d(nn.Module):
    """2D FNO. Input (B, C_in, H, W) -> (B, C_out, H, W); the grid channels
    are linspace(0, 1) per axis."""

    spatial_sharding = True  # runs on the slabs of parallel/spatial.py

    def __init__(self, in_channels: int, out_channels: int, modes1: int,
                 modes2: int, width: int, n_blocks: int = 4,
                 activation: str = "gelu", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.lifting = TorchLinear(in_channels + 2, width, generator=g)
        self.fno_blocks = nn.ModuleList([
            FNOBlock2d(width, modes1, modes2, activation, generator=g)
            for _ in range(n_blocks)])
        self.projection = PointwiseMLP(width, out_channels, width * 4,
                                       generator=g)
        if device is not None:
            self.to(device)

    def forward(self, x):
        x = concat_grid_2d(x.permute(0, 2, 3, 1), 0.0, 1.0)
        x = self.lifting(x)
        for block in self.fno_blocks:
            x = block(x)
        return self.projection(x).permute(0, 3, 1, 2)
