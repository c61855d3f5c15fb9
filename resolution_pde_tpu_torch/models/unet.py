"""PDEBench's UNet, 1D and 2D.

Counterpart of resolution_pde_tpu/models/unet.py (reference models/unet.py:
7-108 and :204-293): four levels of a double conv (conv k3, zero padding 1,
no bias -> norm -> tanh, twice), max pooling by 2 between them, a
bottleneck at 16x the width, then per level a transposed conv (kernel 2,
stride 2) whose output is concatenated with the level's skip and a double
conv, and a final 1x1 conv. The norm is flax's BatchNorm
(models/norms.py) or, with ``use_groupnorm``, GroupNorm over min(8, C)
groups at flax's epsilon 1e-6. The spatial size must divide by 16.

Layout (B, C, X) or (B, C, H, W). The parameters carry the reference's
names (``encoder{1-4}.enc{1-4}conv{1,2}`` / ``norm{1,2}``,
``bottleneck.bottleneckconv{1,2}``, ``decoder{4-1}.dec{4-1}conv{1,2}``,
``upconv{4-1}``, ``conv``), so ``resolution_pde_tpu.utils.torch_import.
import_unet1d/2d`` reads a state_dict of this package. flax's
ConvTranspose correlates where torch's convolves: the bridge
(``utils.jax_bridge.unet1d_state_dict``) flips the taps. Kernels are
initialised as flax's (lecun normal), biases zero.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from resolution_pde_tpu_torch.models.norms import (BatchNorm, conv,
                                                   lecun_normal_)


def _double_conv(in_channels: int, features: int, name: str,
                 use_groupnorm: bool, ndim: int, generator) -> nn.Sequential:
    layers = []
    for j, c_in in ((1, in_channels), (2, features)):
        # flax's GroupNorm epsilon, 1e-6 (torch's default is 1e-5)
        norm = (nn.GroupNorm(min(8, features), features, eps=1e-6)
                if use_groupnorm else BatchNorm(features))
        layers += [
            (f"{name}conv{j}", conv(ndim, c_in, features, 3, 1, bias=False,
                                    generator=generator)),
            (f"{name}norm{j}", norm),
            (f"{name}tanh{j}", nn.Tanh())]
    return nn.Sequential(OrderedDict(layers))


def _up_conv(ndim: int, in_channels: int, out_channels: int,
             generator) -> nn.Module:
    """Transposed conv, kernel 2 stride 2, initialised as flax's
    ConvTranspose (lecun normal over in_channels * 2^ndim, zero bias)."""
    cls = nn.ConvTranspose1d if ndim == 1 else nn.ConvTranspose2d
    m = cls(in_channels, out_channels, 2, stride=2)
    lecun_normal_(m.weight, in_channels * 2 ** ndim, generator)
    nn.init.zeros_(m.bias)
    return m


class _UNet(nn.Module):
    ndim = 1

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 width: int = 32, use_groupnorm: bool = False, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        nd, g, f = self.ndim, generator, width
        feats = [f, f * 2, f * 4, f * 8]
        c_in = in_channels
        for i, feat in enumerate(feats, start=1):
            setattr(self, f"encoder{i}", _double_conv(
                c_in, feat, f"enc{i}", use_groupnorm, nd, g))
            c_in = feat
        self.bottleneck = _double_conv(f * 8, f * 16, "bottleneck",
                                       use_groupnorm, nd, g)
        c_in = f * 16
        for i in (4, 3, 2, 1):
            feat = feats[i - 1]
            setattr(self, f"upconv{i}", _up_conv(nd, c_in, feat, g))
            setattr(self, f"decoder{i}", _double_conv(
                2 * feat, feat, f"dec{i}", use_groupnorm, nd, g))
            c_in = feat
        self.conv = conv(nd, f, out_channels, 1, generator=g)
        if device is not None:
            self.to(device)

    def forward(self, x):
        pool = F.max_pool1d if self.ndim == 1 else F.max_pool2d
        skips = []
        for i in range(1, 5):
            if i > 1:
                x = pool(x, 2)
            x = getattr(self, f"encoder{i}")(x)
            skips.append(x)
        x = self.bottleneck(pool(x, 2))
        for i in (4, 3, 2, 1):
            x = getattr(self, f"upconv{i}")(x)
            x = getattr(self, f"decoder{i}")(torch.cat([x, skips[i - 1]],
                                                       dim=1))
        return self.conv(x)


class UNet1d(_UNet):
    """Input (B, C, X) -> (B, C_out, X); X divisible by 16."""

    ndim = 1


class UNet2d(_UNet):
    """Input (B, C, H, W) -> (B, C_out, H, W); H, W divisible by 16."""

    ndim = 2
