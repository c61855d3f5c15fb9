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

Under a batch sharded over a data-parallel group (``sync_batch_stats``,
which the Trainer enters for its sharded steps), the training statistics
are those of the global batch, as flax's are under GSPMD: the per-channel
sums, then the squared deviations' sums, are all-reduced over the group
(differentiably), and the output is normalised by hand with them.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from resolution_pde_tpu_torch.parallel.collectives import all_reduce_sum

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


@contextlib.contextmanager
def sync_batch_stats(model: nn.Module, group):
    """Within the block, every BatchNorm of ``model`` takes its training
    statistics over ``group``'s rows (None: this process's rows, the
    default)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    old = [m.sync_group for m in norms]
    for m in norms:
        m.sync_group = group
    try:
        yield
    finally:
        for m, g in zip(norms, old):
            m.sync_group = g


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
        self.sync_group = None  # sync_batch_stats

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        if self.sync_group is not None:
            return self._global_forward(x, self.sync_group)
        with torch.no_grad():
            dims = [0] + list(range(2, x.ndim))
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    def _global_forward(self, x, group):
        dims = [0] + list(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        count = torch.tensor(float(x.numel() // x.shape[1]),
                             device=x.device)
        torch.distributed.all_reduce(count, group=group)
        mean = all_reduce_sum(x.sum(dim=dims), group) / count
        dev = x - mean.reshape(shape)
        var = all_reduce_sum((dev * dev).sum(dim=dims), group) / count
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return dev * inv.reshape(shape) + self.bias.reshape(shape)
