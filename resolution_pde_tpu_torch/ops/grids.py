"""Coordinate grids concatenated to model inputs as extra channels.

Counterpart of resolution_pde_tpu/ops/grids.py: ``linspace(lo, hi)`` per
axis, endpoints included, appended after the input channels (the H channel
first, then W).
"""

from __future__ import annotations

import torch


def grid_1d(n: int, lo: float = 0.0, hi: float = 1.0, *, dtype=torch.float32,
            device=None) -> torch.Tensor:
    """(n,) linspace grid, endpoint included (np.linspace semantics): made
    in float64 on ``device`` (no host-to-device copy), then cast."""
    return torch.linspace(lo, hi, n, dtype=torch.float64,
                          device=device).to(dtype)


def concat_grid_2d(x: torch.Tensor, lo: float = 0.0,
                   hi: float = 1.0) -> torch.Tensor:
    """Append two coordinate channels. x: (B, H, W, C) -> (B, H, W, C+2)."""
    b, h, w = x.shape[:3]
    kw = dict(dtype=x.dtype, device=x.device)
    gx = grid_1d(h, lo, hi, **kw)[None, :, None, None].expand(b, h, w, 1)
    gy = grid_1d(w, lo, hi, **kw)[None, None, :, None].expand(b, h, w, 1)
    return torch.cat([x, gx, gy], dim=-1)
