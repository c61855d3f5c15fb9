"""Data normalizers.

Counterpart of resolution_pde_tpu/ops/normalizers.py:
  - SimpleNormalizer: global scalar mean/std, eps 1e-8;
  - UnitGaussianNormalizer: per-location mean/std over the batch axis,
    eps 1e-5.
``encode = (x - mean) / (std + eps)``; ``decode`` is its inverse. ``fit``
uses the Bessel-corrected std (torch's default), as the JAX package does.
``UnitGaussianNormalizer.at_resolution`` and ``adapt_normalizer`` carry the
per-location stats to another grid for the resolution sweep.
"""

from __future__ import annotations

import numpy as np
import torch


class SimpleNormalizer:
    """Global scalar standardization: encode = (x - mean) / (std + eps)."""

    def __init__(self, mean, std, eps: float = 1e-8, device=None):
        self.mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
        self.std = torch.as_tensor(std, dtype=torch.float32, device=device)
        self.eps = eps

    @classmethod
    def fit(cls, x, eps: float = 1e-8) -> "SimpleNormalizer":
        x = torch.as_tensor(x, dtype=torch.float32)
        return cls(x.mean(), x.std(), eps=eps, device=x.device)

    def to(self, device) -> "SimpleNormalizer":
        return type(self)(self.mean, self.std, self.eps, device=device)

    def encode(self, x):
        return (x - self.mean) / (self.std + self.eps)

    def decode(self, x):
        return x * (self.std + self.eps) + self.mean

    def __repr__(self):
        return (f"{type(self).__name__}(mean={self.mean}, std={self.std}, "
                f"eps={self.eps})")


class UnitGaussianNormalizer(SimpleNormalizer):
    """Per-location standardization; ``fit`` reduces over the batch axis."""

    def __init__(self, mean, std, eps: float = 1e-5, device=None):
        super().__init__(mean, std, eps, device)

    @classmethod
    def fit(cls, x, eps: float = 1e-5) -> "UnitGaussianNormalizer":
        x = torch.as_tensor(x, dtype=torch.float32)
        return cls(x.mean(dim=0), x.std(dim=0), eps=eps, device=x.device)

    def at_resolution(self, spatial_shape) -> "UnitGaussianNormalizer":
        """Stats adapted to another spatial grid, for cross-resolution
        evaluation. Downsampling by an integer factor strides, as naive
        eval data is reduced; any other ratio resizes linearly with
        jax.image.resize's weights (which anti-alias when they
        downsample). Returns self when the shape already matches."""
        spatial_shape = tuple(int(s) for s in spatial_shape)
        nsp = len(spatial_shape)
        cur = tuple(self.mean.shape[-nsp:])
        if self.mean.ndim < nsp or cur == spatial_shape:
            return self
        if all(c % t == 0 for c, t in zip(cur, spatial_shape)):
            idx = (Ellipsis,) + tuple(slice(None, None, c // t)
                                      for c, t in zip(cur, spatial_shape))
            return type(self)(self.mean[idx], self.std[idx], self.eps,
                              device=self.mean.device)
        return type(self)(_linear_resize(self.mean, spatial_shape),
                          _linear_resize(self.std, spatial_shape), self.eps,
                          device=self.mean.device)


def _linear_weights(m: int, n: int) -> np.ndarray:
    """(m, n) weights of jax.image.resize(..., "linear") along one axis of
    size m resized to n: a triangle kernel widened by m / n when
    downsampling (antialias), columns normalized, samples outside the
    input zeroed (jax/_src/image/scale.py, compute_weight_mat)."""
    inv_scale = m / n
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n) + 0.5) * inv_scale - 0.5
    w = np.maximum(
        0.0, 1.0 - np.abs(sample[None, :] - np.arange(m)[:, None])
        / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def _linear_resize(t: torch.Tensor, spatial_shape) -> torch.Tensor:
    """Resize the trailing axes of t to spatial_shape with _linear_weights,
    one axis at a time."""
    nsp = len(spatial_shape)
    for i, n in enumerate(spatial_shape):
        d = t.ndim - nsp + i
        if t.shape[d] == n:
            continue
        w = torch.from_numpy(_linear_weights(t.shape[d], n)).to(t.device)
        t = torch.movedim(torch.movedim(t, d, -1) @ w, -1, d)
    return t


def minmax_denormalize(x, min_val, max_val):
    """Min-max denormalization (reference train/training.py:90-91)."""
    return x * (max_val - min_val) + min_val


def adapt_normalizer(norm, spatial_shape):
    """A normalizer for an eval grid: per-location (unit_gaussian) stats go
    through ``at_resolution``; scalar normalizers pass through. Shared by
    the super-resolution and rollout evaluators."""
    if norm is not None and hasattr(norm, "at_resolution"):
        return norm.at_resolution(spatial_shape)
    return norm
