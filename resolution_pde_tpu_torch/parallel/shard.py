"""Applying a layout of parameter specs to a model, and what a sharded
model needs from the trainer: gradient reduction, the global gradient
norm, full state dicts.

A spec is the JAX package's PartitionSpec written as a tuple, one entry a
dimension, ``None`` or a mesh axis name: ``()`` (or all ``None``) keeps
the parameter whole, ``(None, "model")`` shards its dimension 1 over
"model". Specs come as {parameter name: spec} (``fsdp_specs``,
``ffno_tp_specs``, ``moe_ep_specs``, ``merge_specs``). Applied by
``shard_module``, a sharded parameter is replaced by this rank's part,
under its name, so the optimizer (built afterwards) holds the shards and
their moments; per axis:
  - "data" (FSDP): torch's ``fully_shard`` (FSDP2) over the mesh's "data"
    axis, on the unit that runs each such parameter: the first module on
    its path below the root that is not a container (a layer of a
    ModuleList), or the root. The parameter becomes a DTensor sharded on
    its spec's dimension; the unit gathers it before its forward and
    frees it after, gathers it again for its backward, and
    reduce-scatters its gradient, SUMMED (the loss is each rank's share
    of the global one); the unit's other parameters are left to the rest
    of the step. The unit must use the parameter inside its forward;
  - "model" (tensor parallelism): the FeedForward holding the parameter
    computes with its slices (``FeedForward.enable_tensor_parallel``);
  - "expert" (expert parallelism): the stacked experts compute their own
    experts (``enable_expert_parallel`` of models/mgpt.py's stacked MLP).
Specs on an axis of extent 1 keep the parameter whole.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, Shard

from resolution_pde_tpu_torch.parallel.collectives import gather_tensor
from resolution_pde_tpu_torch.parallel.mesh import (axes_group, axis_rank,
                                                    axis_size)

_PLAN = "_parallel_plan"
_AXIS = "_shard_axis"  # on a sharded parameter: its mesh axis


def is_replicated(spec) -> bool:
    return spec is None or all(a is None for a in spec)


def sharded_dim(spec):
    """(dim, axis) of the one sharded dimension of ``spec``, or None."""
    if is_replicated(spec):
        return None
    dims = [(d, a) for d, a in enumerate(spec) if a is not None]
    if len(dims) != 1:
        raise ValueError(f"a spec shards one dimension, got {spec}")
    return dims[0]


def plan(model: nn.Module) -> dict:
    """{name: (axis, dim, full shape)} of the model's sharded parameters
    ({} for a model no spec has sharded)."""
    return getattr(model, _PLAN, {})


def _owner(model: nn.Module, name: str):
    mod_name, _, leaf = name.rpartition(".")
    return (model.get_submodule(mod_name) if mod_name else model), leaf


def _ancestor_with(model: nn.Module, name: str, method: str):
    """The innermost module on ``name``'s path that has ``method``."""
    parts = name.split(".")[:-1]
    found = model if hasattr(model, method) else None
    mod = model
    for p in parts:
        mod = getattr(mod, p)
        if hasattr(mod, method):
            found = mod
    return found


def shard_module(model: nn.Module, mesh, specs: dict) -> dict:
    """Apply ``specs`` to ``model`` in place (see the module docstring).

    Returns {old parameter: new parameter} of the parameters replaced.
    Applying the same specs twice is a no-op; other specs on a sharded
    model raise."""
    active = {name: sharded_dim(spec) for name, spec in specs.items()
              if sharded_dim(spec) is not None
              and axis_size(mesh, sharded_dim(spec)[1]) > 1}
    if plan(model):
        if active != model._parallel_specs:
            raise ValueError("the model is already sharded with other "
                             "specs")
        return {}
    want = {}
    for name, p in model.named_parameters():
        if name not in active:
            continue
        dim, axis = active[name]
        if axis not in ("data", "model", "expert"):
            raise ValueError(f"{name}: no sharded layout on axis {axis!r}")
        n = axis_size(mesh, axis)
        if p.shape[dim] % n:
            raise ValueError(f"{name}: dimension {dim} of {tuple(p.shape)} "
                             f"does not divide over {axis}={n}")
        want[name] = (axis, dim, tuple(p.shape))
    unknown = set(active) - set(want)
    if unknown:
        raise ValueError(f"specs name no parameter of the model: "
                         f"{sorted(unknown)[:5]}")
    if not want:
        return {}
    # tensor and expert parallelism: the holding modules agree first
    tp, ep = {}, {}
    for name, (axis, dim, _) in want.items():
        if axis == "model":
            ff = _ancestor_with(model, name, "enable_tensor_parallel")
            if ff is None:
                raise ValueError(f"{name}: 'model' specs shard FeedForward "
                                 "layers only")
            tp.setdefault(ff, {})[name] = dim
        elif axis == "expert":
            ex = _ancestor_with(model, name, "enable_expert_parallel")
            if ex is None:
                raise ValueError(f"{name}: 'expert' specs shard stacked "
                                 "MoE experts only")
            ep.setdefault(ex, {})[name] = dim
    for ff, dims in tp.items():
        ff.enable_tensor_parallel(mesh.get_group("model"), dims)
    for ex, dims in ep.items():
        ex.enable_expert_parallel(mesh.get_group("expert"), dims)
    replaced = {}
    for name, (axis, dim, _) in want.items():
        if axis == "data":
            continue
        owner, leaf = _owner(model, name)
        old = getattr(owner, leaf)
        new = nn.Parameter(slice_entry(old.detach(), mesh, axis, dim),
                           requires_grad=old.requires_grad)
        setattr(owner, leaf, new)
        replaced[old] = new
    replaced.update(_fully_shard(model, mesh, want))
    for name, (axis, _, _) in want.items():
        setattr(model.get_parameter(name), _AXIS, axis)
    setattr(model, _PLAN, want)
    model._parallel_specs = active
    model._parallel_mesh = mesh
    return replaced


_CONTAINERS = (nn.ModuleList, nn.ModuleDict, nn.ParameterList,
               nn.ParameterDict)


def _unit(model: nn.Module, name: str) -> nn.Module:
    """The module that gathers the FSDP parameter ``name``: the first on
    its path below the root that is not a container, or the root."""
    mod = model
    for part in name.split(".")[:-1]:
        mod = getattr(mod, part)
        if not isinstance(mod, _CONTAINERS):
            return mod
    return model


def _fully_shard(model: nn.Module, mesh, want: dict) -> dict:
    """FSDP2 on every unit of the "data"-sharded parameters (the root
    last, so it leaves its units' parameters alone); returns {old
    parameter: new DTensor parameter}."""
    names = [n for n, (axis, _, _) in want.items() if axis == "data"]
    if not names:
        return {}
    if mesh.device_type != next(model.parameters()).device.type:
        raise ValueError(
            f"FSDP over a {mesh.device_type!r} mesh of a model on "
            f"{next(model.parameters()).device}: "
            "make_mesh(device_type=...) must name the model's device")
    old = {n: model.get_parameter(n) for n in names}
    units = {}
    for n in names:
        units.setdefault(_unit(model, n), []).append(n)
    dp_mesh = mesh["data"] if mesh.ndim > 1 else mesh
    for unit in sorted(units, key=lambda m: m is model):
        dims = {model.get_parameter(n): want[n][1] for n in units[unit]}
        ignored = {p for p in unit.parameters() if p not in dims}
        unit = fully_shard(unit, mesh=dp_mesh, reshard_after_forward=True,
                           shard_placement_fn=lambda p, d=dims: Shard(d[p]),
                           ignored_params=ignored)
        # the ranks' shares add up: a sum, not FSDP's default mean
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)
    return {p: model.get_parameter(n) for n, p in old.items()}


def _params_by_axis(params):
    """{axis or None: [parameters]} by their sharded axis."""
    out = {}
    for p in params:
        out.setdefault(getattr(p, _AXIS, None), []).append(p)
    return out


def split_dtensors(params) -> list:
    """[the plain parameters, the DTensor ones] of ``params``, the
    nonempty ones, each in its order: the optimizer's groups, since one
    foreach update cannot take both kinds."""
    parts = ([p for p in params if not isinstance(p, DTensor)],
             [p for p in params if isinstance(p, DTensor)])
    return [part for part in parts if part]


def local_part(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``t`` (a DTensor's local shard, a view)."""
    return t.to_local() if isinstance(t, DTensor) else t


# the axes a parameter's gradient is summed over where it is not sharded
# on them: the data axes and the grid's "spatial" axis
REPLICA_AXES = ("dcn", "data", "spatial")


def reduce_gradients(params, mesh) -> None:
    """Sum each parameter's gradient over every axis of ``REPLICA_AXES``
    (of extent above 1) that it is not sharded on: the whole parameters
    over all of them, a tensor- or expert-parallel shard too, an FSDP
    shard (sharded on "data", reduce-scattered there by FSDP) over "dcn"
    and "spatial". One flat buffer per set of axes, dtype and device;
    parameters without a gradient are left out (the same on every rank).
    A no-op without a mesh or such an axis."""
    if mesh is None:
        return
    buckets = {}
    for p in params:
        if p.grad is None:
            continue
        own = getattr(p, _AXIS, None)
        axes = tuple(a for a in REPLICA_AXES
                     if a != own and axis_size(mesh, a) > 1)
        if axes:
            g = local_part(p.grad)
            buckets.setdefault((axes, g.dtype, g.device), []).append(g)
    for (axes, _, _), gs in buckets.items():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                        group=axes_group(mesh, axes))
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def grad_sq_norm(params, mesh) -> torch.Tensor:
    """The squared global norm of the (reduced) gradients: the whole
    parameters' squares, plus each sharded axis' shards' squares summed
    over that axis (no collective without a sharded parameter). After
    ``reduce_gradients`` every replica of a parameter holds its whole
    gradient, so a replicated parameter counts once."""
    by_axis = _params_by_axis(params)

    def sq(ps):
        gs = [local_part(p.grad).float() for p in ps if p.grad is not None]
        return sum((g * g).sum() for g in gs) if gs else None

    total = sq(by_axis.get(None, []))
    for axis in ("data", "model", "expert"):
        part = sq(by_axis.get(axis, []))
        if part is None:
            continue
        dist.all_reduce(part, op=dist.ReduceOp.SUM,
                        group=mesh.get_group(axis))
        total = part if total is None else total + part
    return total


# -- full state dicts ----------------------------------------------------
def _gather_entry(t: torch.Tensor, mesh, axis: str, dim: int, like=None):
    # a DTensor's shards through c10d too: full_tensor's functional
    # collectives crash under gloo with CUDA tensors (torch 2.11)
    return gather_tensor(local_part(t), mesh.get_group(axis), dim)


def slice_like(t: torch.Tensor, mesh, axis: str, dim: int, like):
    """This rank's part of a whole tensor, laid out as ``like`` (a DTensor
    under FSDP)."""
    part = slice_entry(t, mesh, axis, dim)
    if isinstance(like, DTensor):
        return DTensor.from_local(part.to(like.device), like.device_mesh,
                                  like.placements, run_check=False)
    return part


def slice_entry(t: torch.Tensor, mesh, axis: str, dim: int):
    """This rank's slice of a whole tensor sharded on ``dim`` over
    ``axis``."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    k = t.shape[dim] // n
    return t.narrow(dim, r * k, k).clone()


def full_shapes(model: nn.Module) -> dict:
    """{state_dict key: full shape}."""
    p = plan(model)
    return {k: list(p[k][2]) if k in p else list(v.shape)
            for k, v in model.state_dict().items()}


def full_state_dict(model: nn.Module) -> dict:
    """The model's state_dict with every shard gathered whole (a
    collective: every rank calls it)."""
    sd = model.state_dict()
    p = plan(model)
    if not p:
        return sd
    mesh = model._parallel_mesh
    return {k: (_gather_entry(v, mesh, p[k][0], p[k][1]) if k in p else v)
            for k, v in sd.items()}


def load_full_state_dict(model: nn.Module, sd: dict) -> None:
    """Load a whole state_dict, each sharded entry sliced to this rank."""
    p = plan(model)
    if p:
        mesh, own = model._parallel_mesh, model.state_dict()
        sd = {k: (slice_like(v, mesh, p[k][0], p[k][1], own[k])
                  if k in p else v) for k, v in sd.items()}
    model.load_state_dict(sd)


def _optimizer_names(model, optimizer) -> dict:
    """{index in the optimizer's state_dict: parameter name}."""
    names = {id(p): n for n, p in model.named_parameters()}
    out, i = {}, 0
    for group in optimizer.param_groups:
        for q in group["params"]:
            out[i] = names.get(id(q))
            i += 1
    return out


def _map_optimizer_state(model, optimizer, osd, fn) -> dict:
    p = plan(model)
    if not p:
        return osd
    names = _optimizer_names(model, optimizer)
    params = dict(model.named_parameters())
    state = {}
    for idx, st in osd["state"].items():
        name = names.get(int(idx))
        if name in p:
            axis, dim, full = p[name]
            st = {k: (fn(v, model._parallel_mesh, axis, dim, params[name])
                      if isinstance(v, torch.Tensor) and v.ndim == len(full)
                      else v) for k, v in st.items()}
        state[idx] = st
    return {**osd, "state": state}


def full_optimizer_state_dict(model, optimizer) -> dict:
    """The optimizer's state_dict with the sharded parameters' moments
    gathered whole (a collective)."""
    return _map_optimizer_state(model, optimizer, optimizer.state_dict(),
                                _gather_entry)


def load_full_optimizer_state_dict(model, optimizer, osd) -> None:
    """Load a whole optimizer state_dict, the moments sliced to this
    rank."""
    optimizer.load_state_dict(
        _map_optimizer_state(model, optimizer, osd, slice_like))
