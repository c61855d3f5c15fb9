"""Pipeline parallelism: a GPipe schedule over a "stage" axis.

Counterpart of resolution_pde_tpu/parallel/pipeline.py. Each rank of the
"stage" axis holds one stage's parameters; the batch is cut into M
microbatches that pass from stage to stage by send/recv, every stage
running one microbatch a tick, M + S - 1 ticks in all; the last stage's
outputs are then broadcast to every rank of the axis. The result is that
of applying the stages in sequence (no arithmetic changes).

The forward only: JAX differentiates its schedule through ``shard_map``,
the port's send/recv carry no autograd graph, so ``pipeline_apply``
raises where a gradient is asked for.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from resolution_pde_tpu_torch.parallel.mesh import axis_rank, axis_size


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage_params):
    """Stack identically structured per-stage trees (dicts, lists, tuples
    of tensors) into one tree with a leading stage dimension."""
    return _map(lambda *xs: torch.stack(xs, dim=0), *per_stage_params)


def pipeline_apply(stage_fn: Callable, stacked_params, x, mesh,
                   axis: str = "stage", n_microbatches: int | None = None):
    """Run ``x`` through S = the mesh's ``axis`` extent stages with a
    GPipe schedule; every rank of the axis calls it with the same
    arguments.

    stage_fn: (stage_params, microbatch) -> microbatch of the same shape
        and dtype (an operator block with its residual).
    stacked_params: a tree whose every leaf has leading dimension S
        (``stack_stage_params``); rank s of the axis uses slice s.
    x: (B, ...), the same on every rank; M = n_microbatches (default S)
        must divide B.
    Returns the (B, ...) output on every rank of the axis."""
    n_stages = axis_size(mesh, axis)
    leading = {leaf.shape[0] for leaf in _leaves(stacked_params)}
    if leading != {n_stages}:
        raise ValueError(f"stacked_params leading dims {leading} != mesh "
                         f"axis {axis}={n_stages}")
    m = n_microbatches or n_stages
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in _leaves(stacked_params) + [x]):
        raise NotImplementedError(
            "pipeline_apply runs the forward only; call it under "
            "torch.no_grad() (the schedule's backward is not ported)")
    stage = axis_rank(mesh, axis)
    group = mesh.get_group(axis)
    params = _map(lambda leaf: leaf[stage], stacked_params)
    xs = x.reshape((m, b // m) + tuple(x.shape[1:]))
    outs = torch.empty_like(xs)
    sends = []
    for t in range(m + n_stages - 1):
        mb = t - stage  # the microbatch this stage runs at tick t
        if not 0 <= mb < m:
            continue
        if stage == 0:
            inp = xs[mb]
        else:
            inp = torch.empty_like(xs[0])
            dist.recv(inp, group=group, group_src=stage - 1)
        y = stage_fn(params, inp)
        if stage == n_stages - 1:
            outs[mb] = y
        else:
            y = y.contiguous()
            sends.append((dist.isend(y, group=group, group_dst=stage + 1),
                          y))
    for work, _ in sends:
        work.wait()
    dist.broadcast(outs, group=group, group_src=n_stages - 1)
    return outs.reshape((b,) + tuple(x.shape[1:]))
