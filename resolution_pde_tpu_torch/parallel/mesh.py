"""Meshes of ranks and the sharding of a batch.

Counterpart of resolution_pde_tpu/parallel/mesh.py. The JAX package runs
one process over a device mesh and GSPMD places the collectives; the port
runs one process per rank of a ``torch.distributed`` group, with a
``DeviceMesh`` whose named axes are JAX's:
  - "dcn":     data parallelism across slices (``make_multislice_mesh``:
               the leading axis); with "data", the data axes;
  - "data":    data parallelism: each rank takes its rows of every batch;
  - "spatial": the grid's H axis of FFNO2D and FNO2d sharded in a train
               step (parallel/spatial.py);
  - "model":   tensor parallelism of the FFNO FeedForward (parallel/tp.py);
  - "expert":  expert parallelism of the stacked MoE experts
               (parallel/ep.py);
  - "stage":   the GPipe schedule (parallel/pipeline.py).
Every rank iterates the same global batches (the loaders' order is a
function of seed and epoch) and ``shard_batch`` keeps its own rows, so
which samples meet in a batch is the single process's. The rows go over
"dcn" and "data" jointly, "dcn"-major, as JAX's ``batch_sharding`` places
them. JAX's ``replicated_sharding`` has no counterpart: the port's
parameters are whole on every rank (but for the shards of
parallel/shard.py).

``init_from_env`` starts the group under ``torchrun`` (``WORLD_SIZE`` in
the environment): NCCL for the card, gloo for the CPU.
"""

from __future__ import annotations

import math
import os
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


DATA_AXES = ("dcn", "data")


def _resolve(axes: Mapping[str, int], n: int, what: str) -> list:
    """The sizes of ``axes`` over n ranks, one -1 inferred."""
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis may be -1")
    if unknown:
        known = math.prod(s for s in sizes if s != -1) or 1
        if n % known:
            raise ValueError(f"{n} {what} not divisible by {known}")
        sizes[unknown[0]] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} {what}")
    return sizes


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized process group: "
            "torch.distributed.init_process_group, or torchrun "
            "(parallel.init_from_env)")
    return dist.get_world_size()


def _device_type(device_type: str | None) -> str:
    if device_type is None:
        return "cuda" if dist.get_backend() == "nccl" else "cpu"
    return device_type


def make_mesh(axes: Mapping[str, int] | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """A DeviceMesh over every rank of the initialized default group.
    Default: all ranks on a single "data" axis.

    axes: ordered {name: size}, one size may be -1 ("all remaining
    ranks"); the sizes must multiply to the world size. device_type: the
    ranks' models' device type, which FSDP keeps its shards on; by
    default "cuda" under NCCL, else "cpu" (gloo, whose collectives also
    take CUDA tensors: ranks on the card under gloo pass "cuda")."""
    n = _world()
    if axes is None:
        axes = {"data": n}
    sizes = _resolve(axes, n, "ranks")
    return init_device_mesh(_device_type(device_type), tuple(sizes),
                            mesh_dim_names=tuple(axes))


def make_multislice_mesh(n_slices: int, axes: Mapping[str, int] | None = None,
                         device_type: str | None = None) -> DeviceMesh:
    """A mesh with a leading "dcn" axis of ``n_slices`` (data parallelism
    across slices) and then the per-slice ``axes`` (default: every rank of
    a slice on "data"), as JAX's ``make_multislice_mesh``: the world size
    must divide into the slices, one per-slice size may be -1, and the
    per-slice sizes must multiply to the ranks of a slice. A rank's slice
    is its rank // (ranks a slice)."""
    n = _world()
    if n % n_slices:
        raise ValueError(f"{n} ranks not divisible by {n_slices} slices")
    per_slice = n // n_slices
    inner = dict(axes) if axes else {"data": per_slice}
    if "dcn" in inner:
        raise ValueError("the per-slice axes may not name 'dcn'")
    sizes = _resolve(inner, per_slice, "ranks a slice")
    return init_device_mesh(_device_type(device_type),
                            (n_slices, *sizes),
                            mesh_dim_names=("dcn", *inner))


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    """The mesh's extent along ``axis`` (1 where the axis is absent)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh | None, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 where it is absent)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def axes_group(mesh: DeviceMesh | None, axes):
    """The process group over the mesh's ``axes`` jointly (the ranks that
    share every other coordinate), ordered as the axes are, the first
    major; None without a mesh or any of the axes. Axes of extent 1 drop
    out, so one axis of extent above 1 is that axis' own group. Groups
    over two or more axes are made once a mesh (every rank makes each
    one, in one order: call this on every rank)."""
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    present = [a for a in axes if a in names]
    if not present:
        return None
    wide = [a for a in present if axis_size(mesh, a) > 1] or present[:1]
    if len(wide) == 1:
        return mesh.get_group(wide[0])
    groups = mesh.__dict__.setdefault("_rpde_axes_groups", {})
    key = tuple(wide)
    if key not in groups:
        dims = [names.index(a) for a in wide]
        rest = [d for d in range(len(names)) if d not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(mesh.mesh.shape[d] for d in dims))
        groups[key], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return groups[key]


def data_group(mesh: DeviceMesh | None):
    """The process group of the data axes, "dcn" and "data" (None without
    a mesh or either axis)."""
    return axes_group(mesh, DATA_AXES)


def data_axis_size(mesh: DeviceMesh | None) -> int:
    """The data-parallel extent ("dcn" x "data")."""
    return axis_size(mesh, "dcn") * axis_size(mesh, "data")


def data_rank(mesh: DeviceMesh | None) -> int:
    """This rank's coordinate over the data axes, "dcn"-major."""
    return axis_rank(mesh, "dcn") * axis_size(mesh, "data") \
        + axis_rank(mesh, "data")


def _rows(x, sel):
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(sel, device=x.device)]
    return np.asarray(x)[sel]


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _first_leaf(batch):
    if isinstance(batch, dict):
        return _first_leaf(next(iter(batch.values())))
    if isinstance(batch, (list, tuple)):
        return _first_leaf(batch[0])
    return batch


def _spatial_rows(x, dim: int, mesh: DeviceMesh):
    n, r = axis_size(mesh, "spatial"), axis_rank(mesh, "spatial")
    h = x.shape[dim]
    if h % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"divide over spatial={n}")
    k = h // n
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, r * k, k)
    idx = [slice(None)] * np.ndim(x)
    idx[dim] = slice(r * k, (r + 1) * k)
    return np.asarray(x)[tuple(idx)]


def shard_batch(batch, mesh: DeviceMesh, straggler: str = "pad",
                spatial_axis: int | None = None):
    """This rank's rows of a global batch: a (nest of tuples, lists and
    dicts of) (B, ...) arrays or tensors, the same on every rank.

    Returns (local_batch, weights). The rows go over the data axes ("dcn"
    x "data", extent n, "dcn"-major: ``data_rank``). A batch whose size n
    does not divide is PADDED (repeating row 0) to the next multiple B_p,
    rank r keeping rows [r B_p/n, (r+1) B_p/n), and ``weights`` is the
    global (B_p,) 0/1 mask of real rows for the loss (float32, numpy or a
    tensor as the batch is); it is None for a batch n divides. A data
    extent of 1 (or no mesh) leaves the rows as they are.

    spatial_axis: with a "spatial" extent S > 1, every leaf also keeps
    the rank's rows [s H/S, (s+1) H/S) of that dimension (H its size, s
    the rank's "spatial" coordinate; JAX's ``batch_sharding(spatial_axis=
    )``); an H that S does not divide raises a ValueError.

    straggler="replicate" instead gives an indivisible batch whole to every
    rank (weights None): exact for models whose TRAINING forward couples
    samples (BatchNorm's batch statistics would count the padded rows).
    The Trainer selects it for models with BatchNorm."""
    if straggler not in ("pad", "replicate"):
        raise ValueError(f"straggler must be 'pad' or 'replicate', "
                         f"got {straggler!r}")
    if spatial_axis is not None and axis_size(mesh, "spatial") > 1:
        batch = _map(lambda x: _spatial_rows(x, spatial_axis, mesh), batch)
    n = data_axis_size(mesh)
    if n == 1:
        return batch, None
    first = _first_leaf(batch)
    b = first.shape[0]
    pad = (-b) % n
    if pad and straggler == "replicate":
        return batch, None
    per = (b + pad) // n
    r = data_rank(mesh)
    sel = np.arange(r * per, (r + 1) * per)
    sel[sel >= b] = 0  # the padding repeats row 0
    local = _map(lambda x: _rows(x, sel), batch)
    if not pad:
        return local, None
    weights = np.concatenate([np.ones(b, np.float32),
                              np.zeros(pad, np.float32)])
    if isinstance(first, torch.Tensor):
        weights = torch.as_tensor(weights, device=first.device)
    return local, weights


def local_weights(weights, mesh: DeviceMesh):
    """This rank's rows of the global (B_p,) weights of ``shard_batch``."""
    per = weights.shape[0] // data_axis_size(mesh)
    r = data_rank(mesh)
    return weights[r * per:(r + 1) * per]


def is_lead() -> bool:
    """True outside a process group and on its rank 0: the process that
    writes checkpoints, figures, tables and logs."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def init_from_env(device) -> tuple:
    """Under torchrun (``WORLD_SIZE`` set) start the default process group
    if it is not up: NCCL for a CUDA device, gloo for the CPU; a CUDA rank
    takes the card ``LOCAL_RANK``. Returns (device, started): the rank's
    device and whether this call started the group (the caller then
    destroys it)."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device, False
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return device, True
