"""Meshes of ranks and the sharding of a batch.

Counterpart of resolution_pde_tpu/parallel/mesh.py. The JAX package runs
one process over a device mesh and GSPMD places the collectives; the port
runs one process per rank of a ``torch.distributed`` group, with a
``DeviceMesh`` whose named axes are JAX's:
  - "data":   data parallelism: each rank takes its rows of every batch;
  - "model":  tensor parallelism of the FFNO FeedForward (parallel/tp.py);
  - "expert": expert parallelism of the stacked MoE experts
              (parallel/ep.py);
  - "stage":  the GPipe schedule (parallel/pipeline.py).
Every rank iterates the same global batches (the loaders' order is a
function of seed and epoch) and ``shard_batch`` keeps its own rows, so
which samples meet in a batch is the single process's.

``init_from_env`` starts the group under ``torchrun`` (``WORLD_SIZE`` in
the environment): NCCL for the card, gloo for the CPU. Not ported: the
"spatial" axis (``batch_sharding(spatial_axis=)``, a distributed FFT) and
the multislice "dcn" axis (``make_multislice_mesh``).
"""

from __future__ import annotations

import math
import os
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(axes: Mapping[str, int] | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """A DeviceMesh over every rank of the initialized default group.
    Default: all ranks on a single "data" axis.

    axes: ordered {name: size}, one size may be -1 ("all remaining
    ranks"); the sizes must multiply to the world size. device_type: the
    ranks' models' device type, which FSDP keeps its shards on; by
    default "cuda" under NCCL, else "cpu" (gloo, whose collectives also
    take CUDA tensors: ranks on the card under gloo pass "cuda")."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized process group: "
            "torch.distributed.init_process_group, or torchrun "
            "(parallel.init_from_env)")
    n = dist.get_world_size()
    if axes is None:
        axes = {"data": n}
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis may be -1")
    if unknown:
        known = math.prod(s for s in sizes if s != -1) or 1
        if n % known:
            raise ValueError(f"{n} ranks not divisible by {known}")
        sizes[unknown[0]] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))


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


def data_group(mesh: DeviceMesh | None):
    """The "data" axis' process group (None without a mesh or the
    axis)."""
    if mesh is None or "data" not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group("data")


def data_axis_size(mesh: DeviceMesh | None) -> int:
    """The data-parallel extent (the "data" axis)."""
    return axis_size(mesh, "data")


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


def shard_batch(batch, mesh: DeviceMesh, straggler: str = "pad"):
    """This rank's rows of a global batch: a (nest of tuples, lists and
    dicts of) (B, ...) arrays or tensors, the same on every rank.

    Returns (local_batch, weights). A batch whose size the data extent n
    does not divide is PADDED (repeating row 0) to the next multiple B_p,
    rank r keeping rows [r B_p/n, (r+1) B_p/n), and ``weights`` is the
    global (B_p,) 0/1 mask of real rows for the loss (float32, numpy or a
    tensor as the batch is); it is None for a batch n divides. A data
    extent of 1 (or no mesh) leaves the batch as it is.

    straggler="replicate" instead gives an indivisible batch whole to every
    rank (weights None): exact for models whose TRAINING forward couples
    samples (BatchNorm's batch statistics would count the padded rows).
    The Trainer selects it for models with BatchNorm."""
    if straggler not in ("pad", "replicate"):
        raise ValueError(f"straggler must be 'pad' or 'replicate', "
                         f"got {straggler!r}")
    n = data_axis_size(mesh)
    if n == 1:
        return batch, None
    first = _first_leaf(batch)
    b = first.shape[0]
    pad = (-b) % n
    if pad and straggler == "replicate":
        return batch, None
    per = (b + pad) // n
    r = axis_rank(mesh, "data")
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
    r = axis_rank(mesh, "data")
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
