"""flax's BatchNorm and flax's convolution and Dense initialisers, for
CNO, UNet and the transformer operators.

``BatchNorm`` is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` as the
JAX package's CNO and UNet use it (models/cno.py:50-52, models/unet.py:
34-36), which differs from ``torch.nn.BatchNorm2d`` in what it keeps:
  - in training the output is normalised with the batch's biased variance
    (as torch does), and the running statistics move as
    ``0.9 * old + 0.1 * batch`` with the BIASED variance, where torch's
    update uses the unbiased n / (n - 1) one;
  - in eval mode the running statistics normalise.
Statistics are over every axis but the channel axis 1, so one class serves
(B, C, X) and (B, C, H, W). The buffers are ``running_mean`` and
``running_var`` (no ``num_batches_tracked``), the names
``resolution_pde_tpu.utils.torch_import`` reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated normal: a unit normal truncated to [-2, 2] has this
# standard deviation, so lecun_normal divides by it
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator=None) -> torch.Tensor:
    """flax's default kernel initialiser (``lecun_normal``: variance 1 /
    fan_in, a truncated normal) in place on ``weight``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std,
                                     2.0 * std, generator=generator)


def conv(ndim: int, in_channels: int, out_channels: int, kernel_size: int,
         padding: int = 0, bias: bool = True, generator=None) -> nn.Module:
    """A Conv1d or Conv2d initialised as flax's ``nn.Conv``: lecun_normal
    kernel, zero bias."""
    cls = nn.Conv1d if ndim == 1 else nn.Conv2d
    m = cls(in_channels, out_channels, kernel_size, padding=padding,
            bias=bias)
    lecun_normal_(m.weight, in_channels * kernel_size ** ndim, generator)
    if bias:
        nn.init.zeros_(m.bias)
    return m


def linear(in_features: int, out_features: int, bias: bool = True,
           generator=None) -> nn.Linear:
    """A Linear initialised as flax's ``nn.Dense``: lecun_normal kernel,
    zero bias."""
    m = nn.Linear(in_features, out_features, bias=bias)
    lecun_normal_(m.weight, in_features, generator)
    if bias:
        nn.init.zeros_(m.bias)
    return m


class BatchNorm(nn.Module):
    """flax's BatchNorm over channel axis 1 (see the module docstring)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        with torch.no_grad():
            dims = [0] + list(range(2, x.ndim))
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)
