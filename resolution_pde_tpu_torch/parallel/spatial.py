"""The "spatial" axis: the grid's H axis sharded over ranks in a train step.

Counterpart of the JAX package's ``batch_sharding(spatial_axis=)``, where
GSPMD inserts the collectives of the sharded FFTs. Here a rank holds a
slab, rows [s H/S, (s+1) H/S) of every (B, C, H, W) input and target (s
its "spatial" coordinate, S the extent), and the layers that couple rows
do so through explicit collectives, each an autograd function:
  - ``slab_to_pencil`` / ``pencil_to_slab``: the all-to-all that swaps
    (B, H/S, W, C) slabs and (B, H, W/S, C) pencils; the backward of each
    is the other. FFNO2D's H pass runs on pencils (ops/spectral.py
    ``factorized_spectral_conv_2d_slabs``);
  - ``reduce_from_group`` (collectives.py): a sum whose backward is the
    identity, for a value every rank then uses alike (the loss's
    per-sample sums of squares, ops/losses.py): every rank computes the
    same loss, and its gradient counts once;
  - ``all_reduce_sum`` (collectives.py): a sum whose backward sums
    again, for a value from which each rank computes different outputs
    (FNO2d's partial DFT along H, whose inverse each rank evaluates at
    its own rows, ops/spectral.py ``spectral_conv_2d_slabs``).
Everything per position (projections, the FeedForward, LayerNorm) runs on
the slab as it is; the grid channel is the rank's rows of the global one
(ops/grids.py). Each parameter's gradient is then a partial sum, which
the trainer's reduction over "spatial" completes (parallel/shard.py
``reduce_gradients``).

The sharded mode is on inside ``sharded(mesh)`` only: ``Trainer`` enters
it around a step's forward and backward, while evaluation, the sweep and
the rollout keep the whole grid on every rank (JAX's ``batch_sharding``
without ``spatial_axis``). It is process-wide, not a context variable,
because the backward and its recomputations (``remat``) run on autograd's
own threads. The models that run sharded say so with a class attribute
``spatial_sharding = True`` (FFNO2D, FNO2d); the trainer refuses the
others.

All-to-all: ``all_to_all_single`` under NCCL and on CPU tensors under
gloo; CUDA tensors under gloo go through host memory (gloo's all-to-all
takes CPU tensors).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

from resolution_pde_tpu_torch.parallel.collectives import (  # noqa: F401
    all_reduce_sum, reduce_from_group)
from resolution_pde_tpu_torch.parallel.mesh import axis_rank, axis_size


@dataclass(frozen=True)
class Shard:
    """The active sharding: the "spatial" group, its extent and this
    rank's coordinate."""

    group: object
    size: int
    rank: int

    def rows(self, h: int) -> slice:
        """This rank's rows of a whole axis of ``h`` points."""
        if h % self.size:
            raise ValueError(f"an axis of {h} points does not divide over "
                             f"spatial={self.size}")
        k = h // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


_active: list = []  # the stack of sharded() blocks, innermost last


def active() -> Shard | None:
    """The innermost ``sharded`` block's Shard, or None outside one."""
    return _active[-1] if _active else None


@contextlib.contextmanager
def using(shard: Shard | None):
    """Run the block sharded as ``shard`` says (None: unsharded)."""
    if shard is None:
        yield None
        return
    _active.append(shard)
    try:
        yield shard
    finally:
        _active.pop()


def sharded(mesh):
    """A context running its block with the grid's H axis sharded over the
    mesh's "spatial" axis (unsharded at an extent of 1 or without the
    axis); it yields the Shard, or None."""
    n = axis_size(mesh, "spatial")
    return using(Shard(mesh.get_group("spatial"), n,
                       axis_rank(mesh, "spatial")) if n > 1 else None)


# -- the all-to-all --------------------------------------------------------
def _all_to_all(chunks: torch.Tensor, group) -> torch.Tensor:
    """(S, ...) chunks, chunk j for rank j -> (S, ...), chunk r from
    rank r."""
    out = torch.empty_like(chunks)
    if chunks.is_cuda and dist.get_backend(group) != "nccl":
        host = chunks.cpu()
        back = torch.empty_like(host)
        dist.all_to_all_single(back, host, group=group)
        out.copy_(back)
    else:
        dist.all_to_all_single(out, chunks, group=group)
    return out


def swap(x: torch.Tensor, group, split_dim: int, cat_dim: int):
    """``split_dim`` cut into S blocks, block j to rank j; the blocks
    received joined along ``cat_dim`` in rank order (no gradient)."""
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of {tuple(x.shape)} does "
                         f"not divide over spatial={n}")
    chunks = torch.stack(x.tensor_split(n, dim=split_dim)).contiguous()
    return torch.cat(_all_to_all(chunks, group).unbind(0), dim=cat_dim)


class _Swap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.args = group, split_dim, cat_dim
        return swap(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, cat_dim = ctx.args
        dx = swap(g.contiguous(), group, cat_dim, split_dim)
        return dx, None, None, None


def slab_to_pencil(x: torch.Tensor, group, h_dim: int = 1, w_dim: int = 2):
    """(.., H/S, .., W, ..) slabs -> (.., H, .., W/S, ..) pencils (H at
    ``h_dim``, W at ``w_dim``); its backward is ``pencil_to_slab``."""
    return _Swap.apply(x, group, w_dim % x.ndim, h_dim % x.ndim)


def pencil_to_slab(x: torch.Tensor, group, h_dim: int = 1, w_dim: int = 2):
    """The inverse of ``slab_to_pencil``."""
    return _Swap.apply(x, group, h_dim % x.ndim, w_dim % x.ndim)


def rows_of(t: torch.Tensor, h: int, shard: Shard) -> torch.Tensor:
    """This rank's rows of a (..., H, W) tensor whose H axis has the whole
    grid's ``h`` points (a normalizer's per-location statistics); ``t`` as
    it is otherwise (a scalar statistic)."""
    if t.ndim < 2 or t.shape[-2] != h:
        return t
    return t[..., shard.rows(h), :]
