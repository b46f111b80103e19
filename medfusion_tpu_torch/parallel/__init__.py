"""Parallelism (port of ``medfusion_tpu/parallel``): process groups, the
('data', 'model') mesh and the placement of parameters on it, batch-sharded
bulk sampling, the mixture-of-experts MLP with expert parallelism, ring
attention and the GPipe pipeline."""

from medfusion_tpu_torch.parallel.mesh import (
    batch_sharding,
    fsdp_partition_spec,
    make_mesh,
    model_partition_spec,
    replicated,
    shard_batch,
    shard_params,
)
from medfusion_tpu_torch.parallel.moe import MoEMLP, moe_aux_loss, moe_capacity, moe_partition_spec
from medfusion_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_partition_spec,
    shard_stage_params,
    stack_stage_params,
)
from medfusion_tpu_torch.parallel.ring_attention import ring_attention
from medfusion_tpu_torch.parallel.sampling import make_sharded_sampler

__all__ = [
    "MoEMLP", "batch_sharding", "fsdp_partition_spec", "make_mesh", "make_sharded_sampler",
    "model_partition_spec", "moe_aux_loss", "moe_capacity", "moe_partition_spec",
    "pipeline_apply", "pipeline_partition_spec", "replicated", "ring_attention",
    "shard_batch", "shard_params", "shard_stage_params", "stack_stage_params",
]
