"""Tensor parallelism: Megatron-style sharding of the FFNO FeedForward
GEMMs over a "model" axis.

Counterpart of resolution_pde_tpu/parallel/tp.py. In every FeedForward
(models/layers.py; hidden = dim * factor) the first linear is
column-parallel (its weight's output rows and its bias sharded), the GELU
after it elementwise on the sharded hidden features, and the second
row-parallel (its weight's input columns sharded, bias whole), its partial
products summed by one all-reduce over "model"; everything else is whole,
and so is any dimension the axis does not divide. The FeedForward's dense
route runs the shards (``FeedForward.enable_tensor_parallel``): a sharded
hidden chain cannot be one fused-kernel launch, so a FeedForward with
``ff_impl='fused'`` refuses a "model" extent above 1.

Use:
    mesh = make_mesh({"data": 2, "model": 2})
    trainer = Trainer(model, mesh=mesh,
                      param_specs=ffno_tp_specs(model, mesh))
"""

from __future__ import annotations

import torch

from resolution_pde_tpu_torch.parallel.mesh import axis_size
from resolution_pde_tpu_torch.parallel.shard import (slice_like, plan,
                                                     shard_module,
                                                     split_dtensors)


def ffno_tp_specs(model, mesh, axis: str = "model") -> dict:
    """{name: spec}: each FeedForward's first linear column-parallel, its
    second row-parallel, everything else whole (``()``). Weights are
    (out, in)."""
    from resolution_pde_tpu_torch.models.layers import FeedForward

    n = axis_size(mesh, axis)
    specs = {name: () for name, _ in model.named_parameters()}
    for mod_name, mod in model.named_modules():
        if not isinstance(mod, FeedForward):
            continue
        prefix = f"{mod_name}.layers" if mod_name else "layers"
        lin0 = mod.layers[0][0]
        if lin0.weight.shape[0] % n == 0:
            specs[f"{prefix}.0.0.weight"] = (axis, None)
            if lin0.bias is not None:
                specs[f"{prefix}.0.0.bias"] = (axis,)
        if len(mod.layers) > 1:
            lin1 = mod.layers[1][0]
            if lin1.weight.shape[1] % n == 0:
                specs[f"{prefix}.1.0.weight"] = (None, axis)
    return specs


def shard_train_state(state, mesh, specs: dict):
    """Shard ``state.model`` by ``specs`` (parallel/shard.py) and point
    ``state.optimizer`` at the shards, any moments it holds sliced with
    them. A model the Trainer already sharded with these specs is left as
    it is. Returns the state."""
    replaced = shard_module(state.model, mesh, specs)
    if not replaced:
        return state
    layout = plan(state.model)
    name_of = {id(q): n for n, q in state.model.named_parameters()}
    opt = state.optimizer
    opt.param_groups = [
        {**group, "params": part} for group in opt.param_groups
        for part in split_dtensors([replaced.get(q, q)
                                    for q in group["params"]])]
    for old, new in replaced.items():
        st = opt.state.pop(old, None)
        if st is None:
            continue
        axis, dim, full = layout[name_of[id(new)]]
        opt.state[new] = {
            k: (slice_like(v, mesh, axis, dim, new)
                if torch.is_tensor(v) and tuple(v.shape) == full else v)
            for k, v in st.items()}
    return state
