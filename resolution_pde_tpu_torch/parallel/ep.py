"""Expert parallelism: the stacked MoE experts sharded over an "expert"
axis.

Counterpart of resolution_pde_tpu/parallel/ep.py. With models/mgpt.py's
``expert_impl='stacked'`` every expert tensor has a leading expert
dimension; sharding it puts 1/E of the experts on each rank. The gate is
dense (every expert contributes), so each rank computes its experts'
outputs and their share of the gated combination, and the combination is
one all-reduce over "expert" (the stacked MLP's
``enable_expert_parallel``).
"""

from __future__ import annotations

from resolution_pde_tpu_torch.parallel.mesh import axis_size


def moe_ep_specs(model, mesh, axis: str = "expert") -> dict:
    """{name: spec}: every stacked expert tensor sharded on dimension 0
    over ``axis``, everything else whole; expert counts the axis does not
    divide stay whole."""
    n = axis_size(mesh, axis)
    specs = {name: () for name, _ in model.named_parameters()}
    for mod_name, mod in model.named_modules():
        if not hasattr(mod, "enable_expert_parallel"):
            continue
        for leaf, p in mod.named_parameters():
            if p.ndim >= 1 and p.shape[0] % n == 0:
                specs[f"{mod_name}.{leaf}"] = (
                    (axis,) + (None,) * (p.ndim - 1))
    return specs
