"""CNO 1D and 2D (the vanilla, ETH tutorial version): the Convolutional
Neural Operator with antialiased up- and downsampling activations.

Counterpart of resolution_pde_tpu/models/cno.py (reference models/CNO1d.py
and models/CNO2d.py). ``CNOBlock`` is conv (kernel 3, zero padding 1),
BatchNorm, then the antialiased activation (``ops.interpolation.
cno_lrelu_1d/2d``), which also resamples to the block's output size;
``LiftProjectBlock`` a CNOBlock without BatchNorm and a conv;
``ResidualBlock`` x + (conv, BN, activation, conv, BN). The body is a UNet:
a lift, per level a ResNet whose output is the level's skip and a block
halving the grid, a ResNet neck, then the decoder, each level's skip
resampled by its ``ED_expansion`` block and concatenated, and a
projection. The sizes are fixed at construction from ``size``; another
input size raises the JAX package's ValueError.

Layout (B, C, X) or (B, C, H, W) throughout. The parameters carry the
reference's names (``lift`` / ``project`` ``.inter_CNOBlock`` /
``.convolution``, ``encoder.{i}``, ``ED_expansion.{k}``, ``decoder.{j}``,
``res_nets.{l}.res_nets.{r}``, ``res_net_neck.res_nets.{r}``, each block's
``.convolution[12]`` and ``.batch_norm[12]``), so
``resolution_pde_tpu.utils.torch_import.import_cno1d/2d`` reads a
state_dict of this package. Kernels are initialised as flax's (lecun
normal), biases zero, from ``generator`` on the CPU, then moved to
``device``. ``_CNOBody`` is the skeleton, shared with the filtered CNO
(models/cno_original.py).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from resolution_pde_tpu_torch.models.norms import BatchNorm, conv
from resolution_pde_tpu_torch.ops.interpolation import (cno_lrelu_1d,
                                                        cno_lrelu_2d)


def _cno_act(x, in_size: int, out_size: int, ndim: int):
    act = cno_lrelu_1d if ndim == 1 else cno_lrelu_2d
    return act(x, in_size, out_size)


class CNOBlock(nn.Module):
    """Conv(k3) -> BN (optional) -> antialiased activation resampling
    ``in_size`` to ``out_size`` (models/CNO1d.py:51-85)."""

    def __init__(self, in_channels: int, out_channels: int, in_size: int,
                 out_size: int, use_bn: bool = True, ndim: int = 1,
                 generator=None):
        super().__init__()
        self.in_size, self.out_size, self.ndim = in_size, out_size, ndim
        self.convolution = conv(ndim, in_channels, out_channels, 3, 1,
                                generator=generator)
        self.batch_norm = BatchNorm(out_channels) if use_bn else None

    def forward(self, x):
        x = self.convolution(x)
        if self.batch_norm is not None:
            x = self.batch_norm(x)
        return _cno_act(x, self.in_size, self.out_size, self.ndim)


class LiftProjectBlock(nn.Module):
    """CNOBlock (no BN) to ``latent_dim`` -> Conv(k3)
    (models/CNO1d.py:91-115)."""

    def __init__(self, in_channels: int, out_channels: int, size: int,
                 latent_dim: int = 64, ndim: int = 1, generator=None):
        super().__init__()
        self.inter_CNOBlock = CNOBlock(in_channels, latent_dim, size, size,
                                       use_bn=False, ndim=ndim,
                                       generator=generator)
        self.convolution = conv(ndim, latent_dim, out_channels, 3, 1,
                                generator=generator)

    def forward(self, x):
        return self.convolution(self.inter_CNOBlock(x))


class ResidualBlock(nn.Module):
    """x + (Conv -> BN -> act -> Conv -> BN) (models/CNO1d.py:121-164)."""

    def __init__(self, channels: int, size: int, use_bn: bool = True,
                 ndim: int = 1, generator=None):
        super().__init__()
        self.size, self.ndim = size, ndim
        self.convolution1 = conv(ndim, channels, channels, 3, 1,
                                 generator=generator)
        self.convolution2 = conv(ndim, channels, channels, 3, 1,
                                 generator=generator)
        self.batch_norm1 = BatchNorm(channels) if use_bn else None
        self.batch_norm2 = BatchNorm(channels) if use_bn else None

    def forward(self, x):
        out = self.convolution1(x)
        if self.batch_norm1 is not None:
            out = self.batch_norm1(out)
        out = _cno_act(out, self.size, self.size, self.ndim)
        out = self.convolution2(out)
        if self.batch_norm2 is not None:
            out = self.batch_norm2(out)
        return x + out


class ResNet(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.res_nets = nn.ModuleList(blocks)

    def forward(self, x):
        for block in self.res_nets:
            x = block(x)
        return x


class _CNOBody(nn.Module):
    """The CNO skeleton over (B, C, *spatial), the blocks made by the
    caller's builders:
      block(c_in, c_out, in_size, out_size), residual(channels, size),
      lift_project(c_in, c_out, size).
    Channels: the lift to channel_multiplier // 2, level i at
    2^i * channel_multiplier (from i = 1: enc_feats below), the decoder's
    concatenations twice a level's channels."""

    def __init__(self, in_dim: int, out_dim: int, size: int, n_layers: int,
                 n_res: int, n_res_neck: int, channel_multiplier: int,
                 block: Callable, residual: Callable,
                 lift_project: Callable):
        super().__init__()
        nl = n_layers
        self.size, self.n_layers = size, nl
        enc = ([channel_multiplier // 2]
               + [2 ** i * channel_multiplier for i in range(nl)])
        enc_sizes = [size // 2 ** i for i in range(nl + 1)]
        dec_sizes = [size // 2 ** (nl - i) for i in range(nl + 1)]
        self.lift = lift_project(in_dim, enc[0], size)
        self.encoder = nn.ModuleList([
            block(enc[i], enc[i + 1], enc_sizes[i], enc_sizes[i + 1])
            for i in range(nl)])
        self.res_nets = nn.ModuleList([
            ResNet([residual(enc[i], enc_sizes[i]) for _ in range(n_res)])
            for i in range(nl)])
        self.res_net_neck = ResNet([residual(enc[nl], enc_sizes[nl])
                                    for _ in range(n_res_neck)])
        # level k's skip resampled to the decoder's size at that level
        self.ED_expansion = nn.ModuleList([
            block(enc[k], enc[k], enc_sizes[k], dec_sizes[nl - k])
            for k in range(nl + 1)])
        # decoder i reads level nl's expansion (i = 0) or the previous
        # decoder's output beside level nl - i's expanded skip
        self.decoder = nn.ModuleList([
            block(enc[nl] if i == 0 else 2 * enc[nl - i], enc[nl - 1 - i],
                  dec_sizes[i], dec_sizes[i + 1])
            for i in range(nl)])
        self.project = lift_project(2 * enc[0], out_dim, size)

    def forward(self, x):
        nl = self.n_layers
        x = self.lift(x)
        skips = []
        for i in range(nl):
            skips.append(self.res_nets[i](x))
            x = self.encoder[i](x)
        x = self.res_net_neck(x)
        for i in range(nl):
            if i == 0:
                x = self.ED_expansion[nl](x)
            else:
                x = torch.cat([x, self.ED_expansion[nl - i](skips[nl - i])],
                              dim=1)
            x = self.decoder[i](x)
        x = torch.cat([x, self.ED_expansion[0](skips[0])], dim=1)
        return self.project(x)

    def check_size(self, x, ndim: int, name: str) -> None:
        spatial = tuple(x.shape[-ndim:])
        if spatial != (self.size,) * ndim:
            got = spatial[0] if ndim == 1 else spatial
            hint = ("resize inputs (the reference's 'resize' training "
                    "strategy)" if ndim == 1 else "resize inputs first")
            raise ValueError(f"{name} was built for size {self.size}, got "
                             f"{got}; {hint}")


class _CNO(_CNOBody):
    ndim = 1

    def __init__(self, in_dim: int, out_dim: int, size: int,
                 N_layers: int = 3, N_res: int = 4, N_res_neck: int = 4,
                 channel_multiplier: int = 16, use_bn: bool = True, *,
                 device=None, generator: torch.Generator | None = None):
        nd, g = self.ndim, generator
        super().__init__(
            in_dim, out_dim, size, N_layers, N_res, N_res_neck,
            channel_multiplier,
            block=lambda ci, co, si, so: CNOBlock(ci, co, si, so, use_bn,
                                                  nd, g),
            residual=lambda c, s: ResidualBlock(c, s, use_bn, nd, g),
            lift_project=lambda ci, co, s: LiftProjectBlock(
                ci, co, s, ndim=nd, generator=g))
        if device is not None:
            self.to(device)

    def forward(self, x):
        self.check_size(x, self.ndim, type(self).__name__)
        return super().forward(x)


class CNO1d(_CNO):
    """Input (B, C, X) with X == size -> (B, C_out, X)."""

    ndim = 1


class CNO2d(_CNO):
    """Input (B, C, H, W) with H == W == size -> (B, C_out, H, W)."""

    ndim = 2
