"""Differentiable collectives over one process group.

The pieces the hand-sharded layouts are built from
(``models.layers.FeedForward``'s tensor-parallel forward, the stacked MoE
experts, flax BatchNorm's global statistics; FSDP is torch's
``fully_shard``, parallel/shard.py). Every rank's loss is its share of the
global loss, and the gradients are summed over the ranks, so each
backward below is the adjoint of its forward under that sum:
  - ``copy_to_group(x, group)``: identity; backward: the gradient summed
    over the group (Megatron's f, the input of a sharded computation);
  - ``reduce_from_group(x, group)``: the sum over the group; backward:
    identity (Megatron's g, the output of a row-parallel product);
  - ``gather_from_group(x, group, dim)``: the shards concatenated along
    ``dim``; backward: this rank's slice of the gradient (the output of a
    column-parallel product that every rank then uses whole);
  - ``all_reduce_sum(x, group)``: the sum over the group; backward: the
    gradient summed over the group (a statistic of every rank's rows).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((n * front.shape[0],) + tuple(front.shape[1:]))
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        k = g.shape[ctx.dim] // n
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * k, k).contiguous(), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x, group, dim: int = -1):
    return _GatherFromGroup.apply(x, group, dim % x.ndim)


def all_reduce_sum(x, group):
    return _AllReduceSum.apply(x, group)


def gather_tensor(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The shards of ``x`` concatenated along ``dim`` (no gradient)."""
    with torch.no_grad():
        return _gather(x.detach(), group, dim)
