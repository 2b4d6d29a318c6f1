"""Parallelism across processes (counterpart of kosmosx_tpu/parallel):
process groups and meshes, context parallelism (the ring and zigzag ring
flash attention and the sequence-parallel step), the sharding rules, data
parallelism and FSDP2, tensor and expert parallelism (``tensor.py``) and
the GPipe and 1F1B pipeline schedules (``pipeline.py``)."""

from kosmosx_torch.parallel.mesh import initialize_distributed, make_mesh
from kosmosx_torch.parallel.pipeline import (make_pipeline_train_step,
                                             make_pipeline_train_step_1f1b,
                                             make_pp_mesh,
                                             pipeline_stage,
                                             pipeline_state_specs)
from kosmosx_torch.parallel.ring_attention import ring_flash_attention
from kosmosx_torch.parallel.seq_parallel import (make_seq_parallel_train_step,
                                                 make_sp_mesh, shift_labels)
from kosmosx_torch.parallel.sharding import (batch_spec, param_specs,
                                             shard_batch, shard_params)

__all__ = [
    "make_mesh", "initialize_distributed",
    "batch_spec", "param_specs", "shard_params", "shard_batch",
    "ring_flash_attention",
    "make_seq_parallel_train_step", "make_sp_mesh", "shift_labels",
    "make_pipeline_train_step", "make_pipeline_train_step_1f1b",
    "make_pp_mesh", "pipeline_stage", "pipeline_state_specs",
]
