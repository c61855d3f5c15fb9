"""Parallelism over a ``torch.distributed`` group: meshes of ranks and
sharding rules.

Counterpart of resolution_pde_tpu/parallel: the batch over "data" (and
the multislice "dcn" axis), the grid's H axis over "spatial" in a train
step (FFNO2D, FNO2d), FSDP over "data", Megatron tensor parallelism over
"model", the stacked MoE experts over "expert", a GPipe schedule over
"stage", differentiable.
"""

from resolution_pde_tpu_torch.parallel.mesh import (
    axis_rank,
    axis_size,
    data_axis_size,
    data_group,
    init_from_env,
    is_lead,
    make_mesh,
    make_multislice_mesh,
    shard_batch,
)
from resolution_pde_tpu_torch.parallel.spatial import (pencil_to_slab,
                                                       sharded,
                                                       slab_to_pencil)
from resolution_pde_tpu_torch.parallel.shard import shard_module
from resolution_pde_tpu_torch.parallel.fsdp import fsdp_specs, merge_specs
from resolution_pde_tpu_torch.parallel.tp import (ffno_tp_specs,
                                                  shard_train_state)
from resolution_pde_tpu_torch.parallel.ep import moe_ep_specs
from resolution_pde_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                        stack_stage_params)

__all__ = [
    "axis_rank", "axis_size", "data_axis_size", "data_group",
    "init_from_env", "is_lead", "make_mesh", "make_multislice_mesh",
    "shard_batch", "sharded", "slab_to_pencil", "pencil_to_slab",
    "shard_module",
    "fsdp_specs", "merge_specs", "ffno_tp_specs", "shard_train_state",
    "moe_ep_specs", "pipeline_apply", "stack_stage_params",
]
