"""Loss functions.

Counterpart of resolution_pde_tpu/ops/losses.py (reference
utils/loss.py:17-60, RelativeL2Loss). Inside ``parallel.spatial.sharded``
each per-sample sum of squares over the rank's slab is summed over
"spatial" (a sum whose backward is the identity) before the square root,
so every rank computes the whole grid's loss and its gradient counts once.
"""

from __future__ import annotations

import torch

from resolution_pde_tpu_torch.parallel import spatial

_EPS = 1e-8


def relative_l2(pred, target, reduction: str | None = "mean",
                eps: float = _EPS, weights=None):
    """Per-sample relative L2 error ``||pred - target|| / (||target|| + eps)``
    over the flattened sample (leading axis = batch), reduced in float32
    whatever the inputs' dtype. reduction: 'mean', 'sum', or None/'none'
    for the per-sample vector. weights: optional (B,) per-sample weights;
    with 'mean' the result is sum(w * rel) / max(sum(w), 1)."""
    pred = pred.flatten(1).float()
    target = target.flatten(1).float()
    shard = spatial.active()
    if shard is None:
        rel = (torch.linalg.vector_norm(pred - target, dim=1)
               / (torch.linalg.vector_norm(target, dim=1) + eps))
    else:
        sq = torch.stack([((pred - target) ** 2).sum(1),
                          (target ** 2).sum(1)])
        sq = spatial.reduce_from_group(sq, shard.group)
        rel = sq[0].sqrt() / (sq[1].sqrt() + eps)
    if weights is not None:
        w = weights.float()
        if reduction == "mean":
            return (rel * w).sum() / torch.clamp(w.sum(), min=1.0)
        if reduction == "sum":
            return (rel * w).sum()
        rel = rel * w
    if reduction == "mean":
        return rel.mean()
    if reduction == "sum":
        return rel.sum()
    if reduction is None or reduction == "none":
        return rel
    raise ValueError(f"unknown reduction {reduction!r}")
