"""The collectives of the parallel package, over ``torch.distributed``
process groups (the port's counterpart of ``lax.ppermute``, ``psum`` and
``all_gather`` inside JAX's ``shard_map``).

Every helper takes the tensors as they lie, on the card or on the host.
On an NCCL group a CUDA tensor travels device to device. A gloo group has
no send or receive for CUDA tensors, so on a gloo group every helper
stages CUDA tensors through host memory: copied to the host, moved by
gloo, copied back. That is one code path, chosen by the group's backend,
never a silent fallback; under gloo its transport time says nothing of the
card's links. Several ranks on one card (NCCL refuses two ranks on one
device) run under gloo.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def _groups(group) -> tuple:
    return group if isinstance(group, tuple) else (group,)


def group_size(group) -> int:
    """The ranks of ``group``, or of a tuple of groups (the product)."""
    n = 1
    for g in _groups(group):
        n *= dist.get_world_size(g)
    return n


def group_rank(group) -> int:
    return dist.get_rank(group)


def _staged(group) -> bool:
    """Whether CUDA tensors go through host memory on ``group`` (gloo)."""
    return dist.get_backend(group) == "gloo"


def _to_wire(t: torch.Tensor, staged: bool) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if staged and t.is_cuda else t


def shift(tensors: Sequence[Optional[torch.Tensor]], group,
          direction: int = 1) -> List[Optional[torch.Tensor]]:
    """One step of a ring: send each tensor to the next rank of ``group``
    and receive its like from the previous one (``lax.ppermute`` with the
    permutation ``d -> d + 1 mod S``), or with ``direction=-1`` to the
    previous rank from the next one (``d -> d - 1 mod S``), with
    ``dist.batch_isend_irecv``. ``None`` entries pass through. On a gloo
    group CUDA tensors are staged through host memory (gloo sends and
    receives host tensors only)."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    rank = group_rank(group)
    nxt = dist.get_global_rank(group, (rank + direction) % n)
    prv = dist.get_global_rank(group, (rank - direction) % n)
    staged = _staged(group)
    ops, outs = [], []
    for t in tensors:
        if t is None:
            outs.append(None)
            continue
        wire = _to_wire(t, staged)
        buf = torch.empty_like(wire)
        ops.append(dist.P2POp(dist.isend, wire, nxt, group))
        ops.append(dist.P2POp(dist.irecv, buf, prv, group))
        outs.append((buf, t))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [None if o is None else o[0].to(o[1].device, non_blocking=False)
            for o in outs]


def all_reduce(tensors: Sequence[torch.Tensor], group,
               op=dist.ReduceOp.SUM) -> List[torch.Tensor]:
    """The tensors reduced over ``group`` (``lax.psum`` for SUM), or over
    each group of a tuple in turn (a mesh's dims), as new tensors on their
    devices: flattened into one buffer per dtype, one collective each.
    CUDA tensors are staged through host memory on a gloo group."""
    tensors = list(tensors)
    for g in _groups(group):
        tensors = _all_reduce(tensors, g, op)
    return tensors


def _all_reduce(tensors, group, op):
    if group_size(group) == 1:
        return [t.detach().clone() for t in tensors]
    staged = _staged(group)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for (_, device), idx in by_dtype.items():
        flat = _flatten_dense_tensors([tensors[i].detach() for i in idx])
        if len(idx) == 1:   # one tensor flattens to a view of itself
            flat = flat.clone()
        wire = _to_wire(flat, staged)
        dist.all_reduce(wire, op=op, group=group)
        flat = wire.to(device)
        for i, t in zip(idx, _unflatten_dense_tensors(
                flat, [tensors[i] for i in idx])):
            out[i] = t
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in rank order
    (``lax.all_gather(..., tiled=True)``); every rank's tensor has the same
    shape. Not differentiable: see ``AllGather``."""
    n = group_size(group)
    if n == 1:
        return t
    staged = _staged(group)
    wire = _to_wire(t.detach(), staged)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


class AllGather(torch.autograd.Function):
    """``all_gather`` with its transpose: the gradient of a rank's piece is
    the sum over ranks of the gathered tensor's gradient at that piece
    (JAX's ``psum_scatter``), an all-reduce and a slice here."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, t.shape[dim]
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce([g], ctx.group)[0]
        start = group_rank(ctx.group) * ctx.size
        return total.narrow(ctx.dim, start, ctx.size).contiguous(), None, None
