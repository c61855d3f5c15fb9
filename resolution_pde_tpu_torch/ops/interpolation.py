"""Antialiased bicubic resampling, the vanilla CNO's up- and downsampling,
and its activation.

Counterpart of resolution_pde_tpu/ops/interpolation.py. JAX's
``jax.image.resize(method="bicubic", antialias=True)`` is the PIL-style
Keys cubic (a = -0.5) with half-pixel centres, its kernel widened by the
scale when downsampling and the taps that fall outside the grid dropped
and the rest renormalised: the function
``F.interpolate(mode="bicubic", antialias=True)`` computes (the reference's
CNO_LReLu, models/CNO1d.py:41-45). ``antialias=False`` would be another
function (a = -0.75, taps clamped at the edge). A 1D signal goes through a
(B, 1, 1, N) view: resizing an axis of one point to one point is the
identity.

On CUDA torch's backward of this resize adds into its gradient with
atomics, so a CNO's training on the card does not repeat bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bicubic_resize_1d(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """x: (..., N) -> (..., out_size), antialiased bicubic."""
    n = x.shape[-1]
    y = F.interpolate(x.reshape(-1, 1, 1, n), size=(1, out_size),
                      mode="bicubic", antialias=True, align_corners=False)
    return y.reshape(*x.shape[:-1], out_size)


def bicubic_resize_2d(x: torch.Tensor, out_size) -> torch.Tensor:
    """x: (..., H, W) -> (..., out_h, out_w), antialiased bicubic."""
    out_h, out_w = out_size
    h, w = x.shape[-2:]
    y = F.interpolate(x.reshape(-1, 1, h, w), size=(out_h, out_w),
                      mode="bicubic", antialias=True, align_corners=False)
    return y.reshape(*x.shape[:-2], out_h, out_w)


def cno_lrelu_1d(x: torch.Tensor, in_size: int, out_size: int,
                 negative_slope: float = 0.01) -> torch.Tensor:
    """CNO's antialiased activation: upsample 2x, LeakyReLU, resample to
    ``out_size``. x: (..., in_size)."""
    x = bicubic_resize_1d(x, 2 * in_size)
    x = F.leaky_relu(x, negative_slope)
    return bicubic_resize_1d(x, out_size)


def cno_lrelu_2d(x: torch.Tensor, in_size: int, out_size: int,
                 negative_slope: float = 0.01) -> torch.Tensor:
    """The 2D activation. x: (..., in_size, in_size)."""
    x = bicubic_resize_2d(x, (2 * in_size, 2 * in_size))
    x = F.leaky_relu(x, negative_slope)
    return bicubic_resize_2d(x, (out_size, out_size))
