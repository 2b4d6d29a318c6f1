"""Process groups and device meshes (counterpart of
kosmosx_tpu/parallel/mesh.py): the rendezvous of the reference's NCCL
process groups, and ``DeviceMesh``es with JAX's axis names.

Axes (kosmosx_tpu/parallel/mesh.py:1-20):

- ``data``: batch data parallelism;
- ``fsdp``: parameter and optimizer-state sharding (ZeRO, FSDP2's
  ``fully_shard``); batches are sharded over it too, so every shard holder
  is also a data worker;
- ``tensor``: tensor parallelism (Megatron's layout, ``parallel/
  tensor.py``): the decoder layers' heads and FFN columns split over it;
- ``expert``: expert parallelism: the MoE expert stacks split over it.
  Batches are replicated over ``tensor`` and ``expert``.

A mesh's ranks are processes, one card each under NCCL. Several ranks on
one card run under gloo (NCCL refuses two ranks on one device); the
collectives of ``parallel/comm.py`` then stage CUDA tensors through host
memory.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "fsdp", "tensor", "expert")


def default_backend() -> str:
    """``nccl`` where every process of this node has a card of its own,
    else ``gloo``: the CPU, or more local processes (torchrun's
    ``LOCAL_WORLD_SIZE``) than visible cards."""
    if not torch.cuda.is_available():
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Join the process group (the reference's ``MASTER_ADDR``/``PORT``/
    ``RANK``/``WORLD_SIZE`` rendezvous and ``init_process_group``).

    Arguments left out are read from torchrun's environment:
    ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR:MASTER_PORT``. A single
    process (one in all) does nothing and returns False; a process that
    has joined already returns True. The backend is ``default_backend()``;
    under NCCL the process takes the card ``LOCAL_RANK`` (modulo the
    visible cards). The JAX package's
    ``initialize_distributed()`` returns at once when called with no
    arguments (kosmosx_tpu/parallel/mesh.py:36-37); this one reads the
    environment, as the JAX CLI's ``--distributed`` help promises."""
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return False
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env['MASTER_PORT']}")
    backend = default_backend()
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def build_mesh(shape: Sequence[int], names: Sequence[str],
               devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the ranks ``devices`` (default:
    every process) in row-major order. Every process must call it, those
    outside ``devices`` too (the groups are made collectively)."""
    ranks = list(range(world_size())) if devices is None else list(devices)
    n = 1
    for s in shape:
        n *= s
    if n != len(ranks):
        raise ValueError(f"mesh {'x'.join(map(str, shape))} != {len(ranks)} "
                         f"processes: launch as many (torchrun, "
                         f"initialize_distributed)")
    if not dist.is_initialized():
        raise ValueError("a mesh needs the process group: call "
                         "initialize_distributed() first")
    return DeviceMesh(_device_type(),
                      torch.tensor(ranks, dtype=torch.int64).reshape(*shape),
                      mesh_dim_names=tuple(names))


def make_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1, expert: int = 1,
              devices: Optional[Sequence[int]] = None) -> Optional[DeviceMesh]:
    """A ``(data, fsdp, tensor, expert)`` mesh; ``data=-1`` takes what is
    left. ``devices``: the ranks it spans (default every process), in
    row-major ``(data, fsdp, tensor, expert)`` order. One process in all
    gives None, the one-device mesh."""
    n = world_size() if devices is None else len(devices)
    if data == -1:
        if n % (fsdp * tensor * expert):
            raise ValueError(f"{n} processes do not split into fsdp={fsdp} "
                             f"x tensor={tensor} x expert={expert}")
        data = n // (fsdp * tensor * expert)
    if data * fsdp * tensor * expert == 1 and n == 1:
        return None
    return build_mesh((data, fsdp, tensor, expert), AXES, devices)


def make_hybrid_mesh(*, dcn_data: int = 1, data: int = -1, fsdp: int = 1,
                     tensor: int = 1) -> Optional[DeviceMesh]:
    """``dcn_data`` replicas of a ``(data, fsdp, tensor)`` node mesh with
    only the ``data`` axis crossing nodes (kosmosx_tpu/parallel/mesh.py:
    70-104): the returned ``data`` axis has ``dcn_data * data`` ranks in
    node-major order, which is torchrun's rank order (rank = node *
    processes per node + local rank)."""
    if dcn_data <= 1:
        return make_mesh(data=data, fsdp=fsdp, tensor=tensor)
    n = world_size()
    if n % dcn_data:
        raise ValueError(f"{n} processes do not split into {dcn_data} nodes")
    per_node = n // dcn_data
    if data == -1:
        data = per_node // (fsdp * tensor)
    return make_mesh(data=dcn_data * data, fsdp=fsdp, tensor=tensor)

