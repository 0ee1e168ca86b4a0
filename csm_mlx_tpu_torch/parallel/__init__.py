"""The distributed layer on `torch.distributed` (port of
`csm_mlx_tpu/parallel/`): device meshes with JAX's axis names, the CSM
tensor-parallel and FSDP placement rules, GPipe pipeline parallelism for
the backbone stack (`parallel.pipeline`) and ring-attention sequence
parallelism (`parallel.sequence`).

JAX is one program over many devices; the port is one process per rank
(launched by `torchrun`, or spawned), each holding its own shard, with the
collectives written out. The trainers take a mesh for data-parallel and
FSDP fine-tuning (`finetune.trainer.TrainArgs.mesh`, `param_sharding`).
"""

from csm_mlx_tpu_torch.parallel.pipeline import (
    pipeline_forward,
    shard_pipeline_params,
    stack_pipeline_params,
)
from csm_mlx_tpu_torch.parallel.sequence import ring_sdpa, shard_sequence
from csm_mlx_tpu_torch.parallel.mesh import (
    create_mesh,
    csm_param_spec,
    data_parallel_spec,
    fsdp_param_spec,
    shard_batch,
    shard_model,
    shard_params,
    shard_params_fsdp,
)

__all__ = [
    "create_mesh",
    "csm_param_spec",
    "data_parallel_spec",
    "fsdp_param_spec",
    "shard_params",
    "shard_params_fsdp",
    "shard_batch",
    "shard_model",
    "pipeline_forward",
    "shard_pipeline_params",
    "stack_pipeline_params",
    "ring_sdpa",
    "shard_sequence",
]
