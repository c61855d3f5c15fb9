"""Pipeline parallelism: a GPipe schedule over a "stage" axis.

Counterpart of resolution_pde_tpu/parallel/pipeline.py. Each rank of the
"stage" axis holds one stage's parameters; the batch is cut into M
microbatches that pass from stage to stage by send/recv, every stage
running one microbatch a tick, M + S - 1 ticks in all; the last stage's
outputs are then broadcast to every rank of the axis. The result is that
of applying the stages in sequence (no arithmetic changes).

The backward (JAX differentiates its schedule through ``shard_map``) is
an autograd function over the schedule: the forward keeps each
microbatch's stage input; the backward runs the schedule the other way,
the last stage first, each stage recomputing ``stage_fn`` on a
microbatch with gradients on, taking its output's gradient from stage +
1 (the last stage: its own, since the output is broadcast, not summed)
and sending its input's gradient to stage - 1. Stage 0's input gradients
are x's, broadcast over the axis; the stacked leaves' gradient is the
whole (S, ...) tensor, each rank's slice gathered over the axis. So on
every rank the gradients equal those of the stages applied in sequence.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from resolution_pde_tpu_torch.parallel.collectives import gather_tensor
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


def _via_host(t: torch.Tensor, group) -> bool:
    """gloo's point-to-point and broadcast take CPU tensors: a CUDA tensor
    goes through host memory (NCCL takes it as it is)."""
    return t.is_cuda and dist.get_backend(group) != "nccl"


def _recv(like: torch.Tensor, group, src: int) -> torch.Tensor:
    host = _via_host(like, group)
    buf = torch.empty_like(like, device="cpu" if host else like.device)
    dist.recv(buf, group=group, group_src=src)
    return buf.to(like.device) if host else buf


def _isend(t: torch.Tensor, group, dst: int):
    """Start sending t; returns (work, buffer), the buffer to keep until
    the work is waited on."""
    buf = t.cpu() if _via_host(t, group) else t.contiguous()
    return dist.isend(buf, group=group, group_dst=dst), buf


def _broadcast(t: torch.Tensor, group, src: int) -> None:
    if _via_host(t, group):
        host = t.cpu()
        dist.broadcast(host, group=group, group_src=src)
        t.copy_(host)
    else:
        dist.broadcast(t, group=group, group_src=src)


def _unflatten(tree, leaves):
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


class _Schedule(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *leaves):
        stage_fn, tree, mesh, axis, m = run
        n_stages = axis_size(mesh, axis)
        stage = axis_rank(mesh, axis)
        group = mesh.get_group(axis)
        params = _unflatten(tree, [leaf[stage] for leaf in leaves])
        b = x.shape[0]
        xs = x.reshape((m, b // m) + tuple(x.shape[1:]))
        outs = torch.empty_like(xs)
        inputs, sends = {}, []
        for t in range(m + n_stages - 1):
            mb = t - stage  # the microbatch this stage runs at tick t
            if not 0 <= mb < m:
                continue
            inp = xs[mb] if stage == 0 else _recv(xs[0], group, stage - 1)
            inputs[mb] = inp
            y = stage_fn(params, inp)
            if stage == n_stages - 1:
                outs[mb] = y
            else:
                sends.append(_isend(y, group, stage + 1))
        for work, _ in sends:
            work.wait()
        _broadcast(outs, group, n_stages - 1)
        ctx.run, ctx.inputs = run, inputs
        ctx.save_for_backward(*leaves)
        return outs.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        stage_fn, tree, mesh, axis, m = ctx.run
        n_stages = axis_size(mesh, axis)
        stage = axis_rank(mesh, axis)
        group = mesh.get_group(axis)
        leaves = ctx.saved_tensors
        want = ctx.needs_input_grad[2:]
        gs = g.reshape((m, g.shape[0] // m) + tuple(g.shape[1:]))
        dparams = [torch.zeros_like(leaf[stage]) for leaf in leaves]
        dxs = torch.zeros_like(gs)
        sends = []
        for mb in range(m):
            gy = (gs[mb] if stage == n_stages - 1
                  else _recv(gs[0], group, stage + 1))
            with torch.enable_grad():
                inp = ctx.inputs[mb].detach().requires_grad_()
                own = [leaf[stage].detach().requires_grad_(w)
                       for leaf, w in zip(leaves, want)]
                y = stage_fn(_unflatten(tree, own), inp)
                need = [inp] + [p for p in own if p.requires_grad]
                got = iter(torch.autograd.grad(y, need, gy,
                                               allow_unused=True))
            dinp = next(got)
            for i, p in enumerate(own):
                d = next(got) if p.requires_grad else None
                if d is not None:
                    dparams[i] += d
            if dinp is None:
                dinp = torch.zeros_like(inp)
            if stage == 0:
                dxs[mb] = dinp
            else:
                sends.append(_isend(dinp, group, stage - 1))
        for work, _ in sends:
            work.wait()
        _broadcast(dxs, group, 0)
        dleaves = [gather_tensor(d.unsqueeze(0), group, 0) if w else None
                   for d, w in zip(dparams, want)]
        dx = dxs.reshape(g.shape) if ctx.needs_input_grad[1] else None
        return (None, dx, *dleaves)


def pipeline_apply(stage_fn: Callable, stacked_params, x, mesh,
                   axis: str = "stage", n_microbatches: int | None = None):
    """Run ``x`` through S = the mesh's ``axis`` extent stages with a
    GPipe schedule; every rank of the axis calls it with the same
    arguments. Differentiable in x and the stacked leaves (see the module
    docstring).

    stage_fn: (stage_params, microbatch) -> microbatch of the same shape
        and dtype (an operator block with its residual); it runs again in
        the backward, so it must be deterministic.
    stacked_params: a tree whose every leaf has leading dimension S
        (``stack_stage_params``); rank s of the axis uses slice s.
    x: (B, ...), the same on every rank; M = n_microbatches (default S)
        must divide B.
    Returns the (B, ...) output on every rank of the axis."""
    n_stages = axis_size(mesh, axis)
    leaves = _leaves(stacked_params)
    leading = {leaf.shape[0] for leaf in leaves}
    if leading != {n_stages}:
        raise ValueError(f"stacked_params leading dims {leading} != mesh "
                         f"axis {axis}={n_stages}")
    m = n_microbatches or n_stages
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by {m} "
                         "microbatches")
    return _Schedule.apply((stage_fn, stacked_params, mesh, axis, m), x,
                           *leaves)
