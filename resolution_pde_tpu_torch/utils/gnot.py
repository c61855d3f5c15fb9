"""GNOT utilities: the tuple container, the weighted Lp losses and the
point-feature normalizers of the point-cloud (MoE-GPT / GNOT) path.

Counterpart of resolution_pde_tpu/utils/gnot.py (reference
utils/gnot_utils.py:18-230). The normalizers hold tensors and work on
tensors or numpy arrays alike; they need no pytree hooks in torch.
"""

from __future__ import annotations

import numpy as np
import torch


class MultipleTensors:
    """Tuple-of-tensors container with indexing (gnot_utils.py:18)."""

    def __init__(self, xs):
        self.xs = tuple(xs)

    def __len__(self):
        return len(self.xs)

    def __getitem__(self, i):
        return self.xs[i]

    def __iter__(self):
        return iter(self.xs)


def _component_rows(pred, target, component: int):
    x = pred[..., component].reshape(pred.shape[0], -1)
    y = target[..., component].reshape(target.shape[0], -1)
    return x, y


def weighted_lp_rel_loss(pred, target, p: int = 2, component: int = 0):
    """Per-sample relative Lp error on one output component, batch mean
    (gnot_utils.py:49 WeightedLpRelLoss semantics)."""
    x, y = _component_rows(pred, target, component)
    diff = torch.sum(torch.abs(x - y) ** p, dim=1) ** (1.0 / p)
    norm = torch.sum(torch.abs(y) ** p, dim=1) ** (1.0 / p)
    return torch.mean(diff / (norm + 1e-8))


def weighted_lp_loss(pred, target, p: int = 2, component: int = 0):
    """Absolute Lp counterpart (gnot_utils.py:102 WeightedLpLoss)."""
    x, y = _component_rows(pred, target, component)
    return torch.mean(torch.sum(torch.abs(x - y) ** p, dim=1) ** (1.0 / p))


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


class UnitTransformer:
    """Column-wise standardization over (N*, d) point features
    (gnot_utils.py:176)."""

    def __init__(self, mean, std, eps: float = 1e-8):
        self.mean = _tensor(mean)
        self.std = _tensor(std)
        self.eps = eps

    @classmethod
    def fit(cls, x, eps: float = 1e-8):
        x2 = _tensor(x).reshape(-1, x.shape[-1])
        # jnp.std's default: the biased (population) deviation
        return cls(x2.mean(dim=0), x2.std(dim=0, unbiased=False), eps=eps)

    def _stats(self, x):
        if isinstance(x, torch.Tensor):
            return (self.mean.to(x.device, x.dtype),
                    self.std.to(x.device, x.dtype))
        return self.mean.numpy(), self.std.numpy()

    def encode(self, x):
        mean, std = self._stats(x)
        return (x - mean) / (std + self.eps)

    def decode(self, x):
        mean, std = self._stats(x)
        return x * (std + self.eps) + mean


class PointWiseUnitTransformer(UnitTransformer):
    """Per-point standardization over the batch axis (gnot_utils.py:206)."""

    @classmethod
    def fit(cls, x, eps: float = 1e-8):
        x = _tensor(x)
        return cls(x.mean(dim=0), x.std(dim=0, unbiased=False), eps=eps)
