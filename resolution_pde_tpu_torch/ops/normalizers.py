"""Data normalizers.

Counterpart of resolution_pde_tpu/ops/normalizers.py:
  - SimpleNormalizer: global scalar mean/std, eps 1e-8;
  - UnitGaussianNormalizer: per-location mean/std over the batch axis,
    eps 1e-5.
``encode = (x - mean) / (std + eps)``; ``decode`` is its inverse. ``fit``
uses the Bessel-corrected std (torch's default), as the JAX package does.
"""

from __future__ import annotations

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
