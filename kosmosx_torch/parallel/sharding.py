"""Sharding rules and placement (counterpart of
kosmosx_tpu/parallel/sharding.py).

``param_specs`` and ``batch_spec`` are the JAX package's rules as pure
functions over parameter paths: each returns, leaf by leaf, the tuple of
mesh axis names (or None) that JAX's ``PartitionSpec`` holds, and the
leaves are placed by them:

- ``shard_batch``: this rank's rows of a global batch (batches shard over
  ``data`` x ``fsdp``, data-major, as ``P(("data", "fsdp"))``), or the
  rank's own batch as it is;
- ``shard_params``: the decoder layers cut over ``tensor`` and ``expert``
  (``parallel/tensor.shard_model``), then, with ``fsdp`` > 1, FSDP2's
  ``fully_shard`` on every decoder layer, then on the root, over the
  ``fsdp`` dim (with ``data`` > 1 the 2-D
  ``(data, fsdp)`` mesh: shards over ``fsdp``, replicas over ``data``).
  Gradients are reduce-scattered as SUMs (the loss of every rank is its
  share of the global mean, ``train/loss.global_batch``). Each
  parameter's local shard is a run of whole rows of it; ``local_shard``
  says where that run lies in the flattened leaf, which the 8-bit
  optimizers need to quantize on the leaf's own blocks. A leaf cut over
  ``tensor`` or ``expert`` is a slice of the whole leaf first, and the
  run lies in that slice (``LocalShard.cuts``, ``param_shards``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

Spec = Tuple[Optional[str], ...]


def _spec_for(names: Tuple, shape: Tuple[int, ...]) -> Spec:
    """kosmosx_tpu/parallel/sharding.py:50-130, over a leaf's path and
    shape."""
    # multiway experts are transparent: the parent of attn.out.A.w is "out"
    strs = [n for n in names if isinstance(n, str) and n not in ("A", "B")]
    last = strs[-1] if strs else ""
    parent = strs[-2] if len(strs) >= 2 else ""
    nd = len(shape)
    if "experts" in strs:
        if last == "w" and nd == 3:
            return ("expert", "tensor", "fsdp") if parent == "fc2" \
                else ("expert", "fsdp", "tensor")
        if nd == 2:
            return ("expert", None) if parent == "fc2" else ("expert", "tensor")
        return ()
    if parent == "router":
        return ("fsdp", None)
    if "lora" in strs:
        return ()
    if last == "table":
        if "pos" in strs or "pos_embed" in strs or "media_pos_emb" in strs:
            return ()
        return ("fsdp", "tensor")
    if last in ("class_embedding", "latents", "media_pos_emb"):
        return ()
    if last in ("scale", "bias") or "ln" in parent or parent.endswith("norm") \
            or parent.startswith("norm"):
        if parent == "ffn_ln":
            return ("tensor",)
        return ()
    if last == "w" and nd == 2:
        if parent in ("out", "fc2", "to_out", "out_proj"):
            return ("tensor", "fsdp")
        return ("fsdp", "tensor")
    if last == "b" and nd == 1:
        if parent in ("out", "fc2", "to_out"):
            return ()
        return ("tensor",)
    if nd >= 2:
        spec: list = [None] * nd
        spec[int(np.argmax(shape))] = "fsdp"
        return tuple(spec)
    return ()


def _leaves(tree, prefix=()):
    """(path, leaf) of a module's parameters (path components split at
    '.', list indices as ints) or of a nested dict/list tree of arrays."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield tuple(int(c) if c.isdigit() else c
                        for c in name.split(".")), p
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def param_specs(params) -> Dict[str, Spec]:
    """name -> the leaf's spec (a tuple of axis names or None, JAX's
    ``PartitionSpec`` leaf by leaf) for a parameter-tree module or a
    nested dict/list tree of arrays, names the '.'-joined paths. A leaf of
    scan-stacked layers (a path through ``layers`` with no list index, the
    JAX package's stacked layout) gets a leading None."""
    out = {}
    for path, leaf in _leaves(params):
        shape = tuple(getattr(leaf, "shape", ()))
        strs = [n for n in path if isinstance(n, str)]
        stacked = ("layers" in strs and not any(isinstance(n, int)
                                               for n in path) and shape)
        base = _spec_for(path, shape[1:] if stacked else shape)
        out[".".join(map(str, path))] = (None, *base) if stacked else base
    return out


def batch_spec(ndim: int = 2) -> Spec:
    """Batches shard over both data axes, data-major; scalars replicate."""
    if ndim == 0:
        return ()
    return (("data", "fsdp"),) + (None,) * (ndim - 1)


def batch_shards(mesh) -> Tuple[int, int]:
    """(index, count) of this rank's batch shard over ``data`` x ``fsdp``
    (data-major), (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    fsdp = mesh["fsdp"].size()
    index = mesh.get_local_rank("data") * fsdp + mesh.get_local_rank("fsdp")
    return index, mesh["data"].size() * fsdp


def shard_batch(batch, mesh, per_process: bool = False):
    """This rank's part of a batch (a dict of arrays or tensors).

    ``per_process=False``: the batch is the GLOBAL one, the same on every
    rank (the convention of kosmosx_tpu/parallel/sharding.py:147-163); each
    leaf of one or more dims keeps this rank's rows. ``per_process=True``:
    every rank holds its OWN rows (a ``shard_stream``'d loader), taken as
    they are; the global batch is their concatenation in rank order."""
    index, count = batch_shards(mesh)
    if per_process or count == 1:
        return batch

    def rows(x):
        if getattr(x, "ndim", 0) == 0:
            return x
        n = x.shape[0]
        if n % count:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{count} data shards")
        return x[index * (n // count):(index + 1) * (n // count)]

    return {k: rows(v) for k, v in batch.items()}


def decoder_layers(model: nn.Module):
    """The decoder layer modules of a model tree (``layers`` at the root or
    under ``decoder``)."""
    for tree in (model, getattr(model, "decoder", None)):
        if isinstance(tree, nn.Module) and "layers" in tree._modules:
            return list(tree._modules["layers"])
    return []


class Root(nn.Module):
    """The FSDP root over a model: ``root(fn, *args)`` runs ``fn(model,
    *args)`` with the root's parameters gathered, whatever function of
    the model ``fn`` is (a loss over ``model.apply``, DPO's log-probs)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args, **kwargs):
        return fn(self.model, *args, **kwargs)


def shard_params(model: nn.Module, mesh) -> Optional[Root]:
    """Place ``model`` over ``mesh`` in place: its decoder layers cut over
    ``tensor`` and ``expert`` (``parallel/tensor.shard_model``), then, with
    ``fsdp`` > 1, FSDP2 (``fully_shard`` on each decoder layer, then on
    the root, a ``Root`` holding the model, which is returned; None
    without FSDP) over ``mesh``'s ``fsdp`` dim (the ``(data, fsdp)`` 2-D
    mesh where ``data`` > 1: shards over ``fsdp``, replicas over
    ``data``). Gradients reduce as SUMs (divide factor 1, sum-only
    collectives, which gloo takes). Run the model through the returned
    root, and its layers through their ``__call__`` (``nn/decoder.
    run_layers`` does), for FSDP's hooks to gather them."""
    from torch.distributed.fsdp import fully_shard

    from kosmosx_torch.parallel.tensor import shard_model

    shard_model(model, mesh)
    if mesh["fsdp"].size() == 1:
        return None
    sub = mesh["fsdp"] if mesh["data"].size() == 1 else mesh["data", "fsdp"]
    root = Root(model)
    units = decoder_layers(model) + [root]
    for unit in units:
        fully_shard(unit, mesh=sub)
    for unit in units:
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)
    return root


@dataclasses.dataclass(frozen=True)
class LocalShard:
    """Where a rank's local piece of a leaf lies: the whole leaf has
    ``numel`` elements and ``shape``; ``cuts`` (dim, start, size) slice it
    first (a ``tensor`` or ``expert`` cut, ``parallel/tensor.py``), and
    the piece is the run of the flattened slice from its element
    ``offset`` (an FSDP shard; the whole slice from 0 without FSDP). The
    ranks of ``group`` (a group or a tuple of groups) hold the other
    pieces."""

    offset: int
    numel: int
    shape: Tuple[int, ...]
    group: Any
    cuts: Tuple[Tuple[int, int, int], ...] = ()

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """The slice ``cuts`` make of ``full`` (a view)."""
        for dim, start, size in self.cuts:
            full = full.narrow(dim, start, size)
        return full

    def flat_index(self, n: int, device) -> torch.Tensor:
        """The positions in the flattened whole leaf of the piece's ``n``
        elements (int64), built over the cut slice alone."""
        starts = dict((dim, start) for dim, start, _ in self.cuts)
        sizes = list(self.shape)
        for dim, _, size in self.cuts:
            sizes[dim] = size
        idx = torch.zeros((), dtype=torch.int64, device=device)
        stride = 1
        for dim in reversed(range(len(sizes))):
            pos = torch.arange(sizes[dim], device=device) + starts.get(dim, 0)
            idx = (pos * stride).view(-1, *[1] * (len(sizes) - 1 - dim)) + idx
            stride *= self.shape[dim]
        return idx.reshape(-1)[self.offset:self.offset + n]


def local_shard(p) -> Optional[LocalShard]:
    """The ``LocalShard`` of a parameter FSDP2 sharded on dim 0 (None for
    a plain tensor): ``torch.chunk``'s rows, ``ceil(rows / n)`` a rank."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(p, DTensor):
        return None
    mesh, placements = p.device_mesh, p.placements
    dim = next(i for i, pl in enumerate(placements) if isinstance(pl, Shard))
    if placements[dim].dim != 0:
        raise ValueError(f"expected a dim-0 shard, got {placements}")
    n = mesh.size(dim)
    rank = mesh.get_local_rank(dim)
    rows = p.shape[0]
    chunk = -(-rows // n)
    inner = p.numel() // rows if rows else 0
    start = min(rank * chunk, rows)
    return LocalShard(start * inner, p.numel(), tuple(p.shape),
                      mesh.get_group(dim))


def param_shards(model: nn.Module, names=None) -> Dict[str, Optional[LocalShard]]:
    """name -> the ``LocalShard`` of each parameter of ``model`` (of those
    in ``names``): its FSDP run (``local_shard``) within its ``tensor`` or
    ``expert`` cut (``model.shard_cuts``), None for a whole one."""
    cuts = getattr(model, "shard_cuts", {})
    out = {}
    for name, p in model.named_parameters():
        if names is not None and name not in names:
            continue
        run, cut = local_shard(p), cuts.get(name)
        if cut is None:
            out[name] = run
            continue
        numel = int(np.prod(cut.shape))
        out[name] = LocalShard(
            0 if run is None else run.offset, numel, cut.shape,
            cut.groups if run is None else (run.group,) + cut.groups,
            cut.slices)
    return out


def local_piece(full: torch.Tensor, shard: Optional[LocalShard],
                local_shape) -> torch.Tensor:
    """A rank's piece of the full tensor ``full`` (the whole tensor for
    ``shard`` None)."""
    if shard is None:
        return full
    n = int(np.prod(local_shape)) if len(local_shape) else 1
    flat = shard.cut(full).reshape(-1)
    return flat[shard.offset:shard.offset + n].reshape(local_shape)


def whole(t: torch.Tensor, shard: Optional[LocalShard]) -> torch.Tensor:
    """The whole leaf of a rank's piece ``t`` (a collective over the
    shard's groups: every rank must call it; ``t`` itself for None)."""
    if shard is None:
        return t
    from kosmosx_torch.parallel.comm import all_reduce

    full = t.new_zeros(shard.shape)
    run = torch.zeros(shard.cut(full).numel(), dtype=t.dtype,
                      device=t.device)
    run[shard.offset:shard.offset + t.numel()] = t.reshape(-1)
    shard.cut(full).copy_(run.view(shard.cut(full).shape))
    return all_reduce([full], shard.group)[0]
