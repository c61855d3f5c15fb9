"""Fully-sharded data parallelism (ZeRO-3 style) over the "data" axis.

Counterpart of resolution_pde_tpu/parallel/fsdp.py: each chosen parameter
(and so its AdamW moments) is held as 1/n of itself per rank, through
torch's ``fully_shard`` on the layer that runs it (parallel/shard.py): the
layer gathers it whole before its forward and frees it after, gathers it
again for its backward, and reduce-scatters its gradient onto the shard,
so a rank holds one layer's whole parameters at a time. Parameters
smaller than ``min_size`` stay whole and their gradients are all-reduced
with the rest of the data-parallel step.

Use:
    mesh = make_mesh({"data": 4})
    trainer = Trainer(model, mesh=mesh, param_specs=fsdp_specs(model, mesh))

Composes with a "model" axis: ``merge_specs(ffno_tp_specs(...),
fsdp_specs(...))``.
"""

from __future__ import annotations

import math

from resolution_pde_tpu_torch.parallel.mesh import axis_size
from resolution_pde_tpu_torch.parallel.shard import is_replicated


def fsdp_specs(model, mesh, axis: str = "data", min_size: int = 16384):
    """{name: spec} sharding each parameter's largest dimension that the
    axis extent divides (the first of equal ones); parameters smaller than
    ``min_size`` elements, and all of them on an axis of extent 1, stay
    whole (``()``)."""
    n = axis_size(mesh, axis)
    specs = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        specs[name] = ()
        if n <= 1 or not shape or math.prod(shape) < min_size:
            continue
        for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[d] % n == 0:
                specs[name] = tuple(axis if i == d else None
                                    for i in range(len(shape)))
                break
    return specs


def merge_specs(primary: dict, fallback: dict) -> dict:
    """Per name: ``primary``'s spec unless it keeps the parameter whole,
    else ``fallback``'s (e.g. tensor parallelism for the FF GEMMs, FSDP
    for the rest)."""
    return {name: (spec if not is_replicated(spec)
                   else fallback.get(name, ()))
            for name, spec in {**fallback, **primary}.items()}
