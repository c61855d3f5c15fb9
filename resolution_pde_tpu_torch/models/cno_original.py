"""CNO 2D, the "original" version: the CNO skeleton with designed low-pass
filters (alias-free resampling) in place of the bicubic activations.

Counterpart of resolution_pde_tpu/models/cno_original.py (reference
conf/model/cno_2d/cno_2d_original.yaml, whose ``CNO/`` module the JAX
package rebuilt from the config). ``_FilteredAct`` is ops.filters'
filtered LeakyReLU with a net resampling of in_size to in_size, in_size / 2
(down by 2u from the grid upsampled by u) or 2 * in_size (up by 2u, down
by u); ``_Block`` conv, BN, filtered activation; ``_LiftProject`` conv to
``latent_lift_proj_dim``, filtered activation, conv, with no BN and no
output activation; ``_ResBlock`` x + (block, conv, BN). ``radial``
selects the jinc filter. The skeleton is models/cno.py's ``_CNOBody``, so
the parameters are named as the vanilla CNO's (``lift``, ``encoder.{i}``,
``res_nets.{l}.res_nets.{r}``, ``res_net_neck``, ``ED_expansion.{k}``,
``decoder.{j}``, ``project``); inside, ``_Block`` holds ``convolution`` and
``batch_norm``, ``_ResBlock`` ``block``, ``convolution`` and
``batch_norm``, ``_LiftProject`` ``convolution1`` and ``convolution2``.
``utils.jax_bridge.cno2d_original_state_dict`` maps flax's auto-names
onto them.
"""

from __future__ import annotations

import torch
from torch import nn

from resolution_pde_tpu_torch.models.cno import _CNOBody
from resolution_pde_tpu_torch.models.norms import BatchNorm, conv
from resolution_pde_tpu_torch.ops.filters import (downsample_2d,
                                                  filtered_lrelu_2d,
                                                  upsample_2d)


class _FilteredAct(nn.Module):
    """Filtered LeakyReLU resampling (B, C, in_size, in_size) to
    out_size: in_size, in_size // 2 or 2 * in_size."""

    def __init__(self, in_size: int, out_size: int, lrelu_upsampling: int,
                 filter_kw: dict):
        super().__init__()
        if out_size not in (in_size, in_size // 2, 2 * in_size):
            raise ValueError(
                f"unsupported resample {in_size}->{out_size}")
        self.in_size, self.out_size = in_size, out_size
        self.u = lrelu_upsampling
        self.filter_kw = filter_kw

    def forward(self, x):
        u, kw = self.u, self.filter_kw
        if self.out_size == self.in_size:
            return filtered_lrelu_2d(x, up_factor=u, **kw)
        if self.out_size == self.in_size // 2:
            return filtered_lrelu_2d(x, up_factor=u, out_factor=2 * u, **kw)
        x = upsample_2d(x, 2 * u, **kw)
        x = torch.where(x >= 0, x, 0.01 * x)
        return downsample_2d(x, u, **kw)


class _Block(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, in_size: int,
                 out_size: int, use_bn: bool, lrelu_upsampling: int,
                 filter_kw: dict, generator=None):
        super().__init__()
        self.convolution = conv(2, in_channels, out_channels, 3, 1,
                                generator=generator)
        self.batch_norm = BatchNorm(out_channels) if use_bn else None
        self.act = _FilteredAct(in_size, out_size, lrelu_upsampling,
                                filter_kw)

    def forward(self, x):
        x = self.convolution(x)
        if self.batch_norm is not None:
            x = self.batch_norm(x)
        return self.act(x)


class _LiftProject(nn.Module):
    """conv -> filtered activation -> conv, no BN and no output activation
    (cno_2d_original.yaml:16-17: a signed regression head)."""

    def __init__(self, in_channels: int, out_channels: int, latent_dim: int,
                 size: int, lrelu_upsampling: int, filter_kw: dict,
                 generator=None):
        super().__init__()
        self.convolution1 = conv(2, in_channels, latent_dim, 3, 1,
                                 generator=generator)
        self.act = _FilteredAct(size, size, lrelu_upsampling, filter_kw)
        self.convolution2 = conv(2, latent_dim, out_channels, 3, 1,
                                 generator=generator)

    def forward(self, x):
        return self.convolution2(self.act(self.convolution1(x)))


class _ResBlock(nn.Module):
    def __init__(self, channels: int, size: int, use_bn: bool,
                 lrelu_upsampling: int, filter_kw: dict, generator=None):
        super().__init__()
        self.block = _Block(channels, channels, size, size, use_bn,
                            lrelu_upsampling, filter_kw, generator)
        self.convolution = conv(2, channels, channels, 3, 1,
                                generator=generator)
        self.batch_norm = BatchNorm(channels) if use_bn else None

    def forward(self, x):
        out = self.convolution(self.block(x))
        if self.batch_norm is not None:
            out = self.batch_norm(out)
        return x + out


class CNO2dOriginal(_CNOBody):
    """Filtered CNO. Input (B, C, H, W) with H == W == size."""

    def __init__(self, in_dim: int, out_dim: int, size: int,
                 N_layers: int = 3, N_res: int = 4, N_res_neck: int = 4,
                 channel_multiplier: int = 16, use_bn: bool = True,
                 cutoff_den: float = 2.0001, filter_size: int = 6,
                 lrelu_upsampling: int = 2, half_width_mult: float = 0.8,
                 radial: bool = False, latent_lift_proj_dim: int = 64, *,
                 device=None, generator: torch.Generator | None = None):
        g, u = generator, lrelu_upsampling
        fkw = dict(cutoff_den=cutoff_den, filter_size=filter_size,
                   half_width_mult=half_width_mult, radial=radial)
        super().__init__(
            in_dim, out_dim, size, N_layers, N_res, N_res_neck,
            channel_multiplier,
            block=lambda ci, co, si, so: _Block(ci, co, si, so, use_bn, u,
                                                fkw, g),
            residual=lambda c, s: _ResBlock(c, s, use_bn, u, fkw, g),
            lift_project=lambda ci, co, s: _LiftProject(
                ci, co, latent_lift_proj_dim, s, u, fkw, g))
        if device is not None:
            self.to(device)

    def forward(self, x):
        if x.shape[-1] != self.size or x.shape[-2] != self.size:
            raise ValueError(f"CNO2dOriginal built for size {self.size}, "
                             f"got {tuple(x.shape[-2:])}")
        return super().forward(x)
