"""Parallelism across processes (counterpart of kosmosx_tpu/parallel):
process groups and meshes, context parallelism (the ring and zigzag ring
flash attention and the sequence-parallel step), the sharding rules, data
parallelism and FSDP2. The pipeline schedules (``pipeline.py``) and tensor
and expert parallelism are ROADMAP Queue 1 item 10b."""

from kosmosx_torch.parallel.mesh import initialize_distributed, make_mesh
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
]
