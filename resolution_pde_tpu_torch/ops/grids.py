"""Coordinate grids concatenated to model inputs as extra channels.

Counterpart of resolution_pde_tpu/ops/grids.py: ``linspace(lo, hi)`` per
axis, endpoints included, appended after the input channels (the H channel
first, then W). Inside ``parallel.spatial.sharded`` a (B, H/S, W, C) slab
takes its rows of the whole grid's H channel.
"""

from __future__ import annotations

import torch

from resolution_pde_tpu_torch.parallel import spatial


def grid_1d(n: int, lo: float = 0.0, hi: float = 1.0, *, dtype=torch.float32,
            device=None) -> torch.Tensor:
    """(n,) linspace grid, endpoint included (np.linspace semantics): made
    in float64 on ``device`` (no host-to-device copy), then cast."""
    return torch.linspace(lo, hi, n, dtype=torch.float64,
                          device=device).to(dtype)


def concat_grid_1d(x: torch.Tensor, lo: float = 0.0,
                   hi: float = 1.0) -> torch.Tensor:
    """Append a coordinate channel. x: (B, X, C) -> (B, X, C+1)."""
    b, n = x.shape[:2]
    g = grid_1d(n, lo, hi, dtype=x.dtype, device=x.device)
    return torch.cat([x, g[None, :, None].expand(b, n, 1)], dim=-1)


def concat_grid_2d(x: torch.Tensor, lo: float = 0.0,
                   hi: float = 1.0) -> torch.Tensor:
    """Append two coordinate channels. x: (B, H, W, C) -> (B, H, W, C+2);
    a slab of the sharded grid (``parallel.spatial``) takes its rows of
    the whole H axis' linspace."""
    b, h, w = x.shape[:3]
    kw = dict(dtype=x.dtype, device=x.device)
    shard = spatial.active()
    if shard is None:
        hx = grid_1d(h, lo, hi, **kw)
    else:
        hx = grid_1d(h * shard.size, lo, hi, **kw)[shard.rows(h * shard.size)]
    gx = hx[None, :, None, None].expand(b, h, w, 1)
    gy = grid_1d(w, lo, hi, **kw)[None, None, :, None].expand(b, h, w, 1)
    return torch.cat([x, gx, gy], dim=-1)
