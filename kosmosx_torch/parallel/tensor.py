"""Tensor and expert parallelism (the port's counterpart of what GSPMD does
with the ``tensor`` and ``expert`` axes of kosmosx_tpu/parallel/
sharding.py:9-17,54-67,84-103).

``shard_model(model, mesh)`` cuts every decoder-layer leaf whose spec
(``sharding.param_specs``, JAX's rules leaf by leaf) names ``tensor`` or
``expert`` to this rank's slice, in place, and marks each decoder layer
with the ``Axis`` of each such mesh dim. The layer code
(``nn/decoder.py``, ``nn/attention.py``, ``nn/moe.py``) reads the marks:

- Megatron's layout over ``tensor``: q, k, v and fc1 are column-parallel
  (each rank holds ``heads / tp`` heads and ``ffn_dim / tp`` columns), the
  attention's out-projection and fc2 row-parallel, with one all-reduce
  after each. The collectives are the conjugate pair of autograd
  functions: ``copy_to`` (identity forward, all-reduce backward) at the
  input of a column-parallel block, ``reduce_from`` (all-reduce forward,
  identity backward) at the output of a row-parallel one, so that every
  rank's gradients are those of the one loss they all compute.
- The two sub-LNs over a sharded width are distributed LayerNorms
  (``layer_norm``: mean and variance sums all-reduced by ``all_sum``, an
  all-reduce both ways): ``ffn_ln``, whose spec is ``("tensor",)``, and the
  attention's ``inner_ln``, which is replicated, so each rank applies its
  slice of it and ``copy_to`` on the whole leaf sums its gradient.
- LoRA factors are replicated (spec ``()``): each rank applies its slice
  of ``b`` (column-parallel) or ``a`` (row-parallel) under ``copy_to``,
  per-row factors (multi-LoRA serving) every row's.
- W8 weights (``utils/quantize.py``) are cut by the rule of the float
  weight they replace: column-parallel codes and scales on their columns,
  row-parallel codes on their rows with the scales whole.
- Over ``expert`` each rank holds ``E / ep`` experts; the batch is
  replicated over ``expert``, so every rank routes all its rows alike,
  runs its own experts' part of the dispatch buffer and the combine is a
  sum over ``expert`` (``reduce_from``). No all-to-all is needed while
  tokens are not sharded over ``expert``.

The embedding table and the vocabulary projection stay whole over
``tensor`` (PERF.md says why). Each rank's cut of a leaf is recorded in
``model.shard_cuts`` (name -> ``Cut``), which ``sharding.param_shards``
turns into the ``LocalShard`` the optimizers and checkpoints read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from kosmosx_torch.parallel.comm import all_reduce


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh dim as the layer code sees it: its process ``group``, its
    ``size`` and this rank's index on it."""

    group: Any
    size: int
    rank: int

    def __deepcopy__(self, memo):  # a copied model shares its groups
        return self

    def part(self, n: int) -> slice:
        """This rank's part of ``n`` (which the size divides)."""
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def mesh_axis(mesh, name: str) -> Optional[Axis]:
    """The ``Axis`` of ``mesh``'s dim ``name``, None where it is 1 wide."""
    if mesh is None or mesh[name].size() == 1:
        return None
    return Axis(mesh.get_group(name), mesh[name].size(),
                mesh.get_local_rank(name))


def axes(params) -> Tuple[Optional[Axis], Optional[Axis]]:
    """(tensor, expert) axes a decoder layer (or a model tree, read at its
    first decoder layer) is cut over; (None, None) for a whole one."""
    from kosmosx_torch.parallel.sharding import decoder_layers

    node = params
    if isinstance(node, nn.Module) and "tensor_axis" not in vars(node) \
            and ("layers" in node._modules or "decoder" in node._modules):
        found = decoder_layers(node)
        node = found[0] if found else node
    return (getattr(node, "tensor_axis", None),
            getattr(node, "expert_axis", None))


# ---------------------------------------------------------------------------
# the conjugate collectives
# ---------------------------------------------------------------------------


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce([g], ctx.group)[0], None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce([x], group)[0]

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce([x], group)[0]

    @staticmethod
    def backward(ctx, g):
        return all_reduce([g], ctx.group)[0], None


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Identity forward, gradient summed over ``axis`` backward: the input
    of a block whose ranks each use part of ``x``."""
    return x if axis is None else _Copy.apply(x, axis.group)


def reduce_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """``x`` summed over ``axis`` forward, identity backward: the output of
    a block whose ranks each hold a part of the sum."""
    return x if axis is None else _Reduce.apply(x, axis.group)


def all_sum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """``x`` summed over ``axis`` both ways: a statistic every rank uses
    for its own part (a distributed LayerNorm's sums)."""
    return x if axis is None else _Sum.apply(x, axis.group)


# ---------------------------------------------------------------------------
# layers over a sharded width
# ---------------------------------------------------------------------------


def layer_norm(params, x: torch.Tensor, axis: Axis, *, sliced: bool,
               eps: float = 1e-5) -> torch.Tensor:
    """``nn/layers.layer_norm`` over a last dim split over ``axis``: ``x``
    holds this rank's columns. ``sliced``: the scale and bias are this
    rank's slices (``ffn_ln``); else they are the whole replicated leaves
    and the rank takes its part under ``copy_to`` (``inner_ln``)."""
    x32 = x.float()
    n = x.shape[-1] * axis.size
    mean = all_sum(x32.sum(dim=-1, keepdim=True), axis) / n
    var = all_sum((x32 - mean).square().sum(dim=-1, keepdim=True), axis) / n
    y = (x32 - mean) * torch.rsqrt(var + eps)

    def part(t):
        return t if sliced else copy_to(t, axis)[..., axis.part(t.shape[-1])]

    y = y * part(params["scale"]).float()
    if "bias" in params:
        y = y + part(params["bias"]).float()
    return y.to(x.dtype)


def _lora_part(params, axis: Axis, row: bool):
    """A linear's tree with its LoRA factors cut to this rank's part (the
    rows of ``a`` for a row-parallel linear, the columns of ``b`` for a
    column-parallel one), under ``copy_to``. Per-row factors (multi-LoRA
    serving: ``a`` (B, in, r), ``b`` (B, r, out)) are cut alike, every
    row's; ``scale`` is whole."""
    if "lora" not in params:
        return params
    lora = params["lora"]
    a, b = copy_to(lora["a"], axis), copy_to(lora["b"], axis)
    if row:
        a = a[..., axis.part(a.shape[-2]), :]
    else:
        b = b[..., axis.part(b.shape[-1])]
    return {**_linear_tree(params, drop="lora"),
            "lora": {"a": a, "b": b, "scale": lora["scale"]}}


def _linear_tree(params, drop: str):
    """A linear's tree (a dict or a parameter-tree module) as a dict,
    without its ``drop`` entry."""
    return {k: params[k] for k in ("w", "b", "lora")
            if k != drop and k in params}


def column_linear(params, x: torch.Tensor, axis: Axis, *,
                  dtype=None) -> torch.Tensor:
    """A column-parallel linear on ``x`` (the block's input, through
    ``copy_to`` already): this rank's output columns."""
    from kosmosx_torch.nn import layers

    return layers.linear(_lora_part(params, axis, row=False), x, dtype=dtype)


def row_linear(params, x: torch.Tensor, axis: Axis, *,
               dtype=None) -> torch.Tensor:
    """A row-parallel linear on this rank's input columns ``x``: the
    partial products summed over ``axis`` (``reduce_from``), then the
    bias, which is whole."""
    from kosmosx_torch.nn import layers

    part = _lora_part(_linear_tree(params, drop="b"), axis, row=True)
    y = reduce_from(layers.linear(part, x, dtype=dtype), axis)
    if "b" in params:
        b = params["b"]
        y = y + (b.to(dtype) if dtype is not None else b)
    return y


# ---------------------------------------------------------------------------
# cutting a model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Cut:
    """A rank's slice of a leaf: ``slices`` of (dim, start, size) of the
    whole leaf of ``shape``, held by the ranks of ``groups``."""

    shape: Tuple[int, ...]
    slices: Tuple[Tuple[int, int, int], ...]
    groups: Tuple[Any, ...]

    def __deepcopy__(self, memo):
        return self


def _layer_prefixes(model: nn.Module) -> Dict[str, nn.Module]:
    from kosmosx_torch.parallel.sharding import decoder_layers

    layers = {id(m) for m in decoder_layers(model)}
    return {name: m for name, m in model.named_modules() if id(m) in layers}


def _w8_spec(mod: nn.Module, owner: str, leaf: str):
    """The spec of a W8 leaf (``{"q", "scale"}`` of the linear weight at
    ``owner``, held by ``mod``) by the rule of the float weight it
    replaces, or None for any other leaf. JAX's specs give the codes no
    ``tensor`` axis (GSPMD gathers them); the port cuts them as the float
    weight: the codes (…, in, out) on its dims, the scales (…, 1, out) on
    the columns only, so a row-parallel cut keeps them whole (each column's
    scale is common to every row, so the ranks' scaled partial products
    sum to the whole product)."""
    from kosmosx_torch.parallel.sharding import _spec_for

    q = mod._parameters.get("q")
    if leaf not in ("q", "scale") or "scale" not in mod._parameters \
            or q is None or q.is_floating_point():
        return None
    path = tuple(int(c) if c.isdigit() else c for c in owner.split("."))
    base = _spec_for(path, tuple(q.shape[-2:]))
    lead = (None,) * (q.ndim - 2)
    return lead + (base if leaf == "q" else (None, base[-1]))


def shard_model(model: nn.Module, mesh) -> Dict[str, Cut]:
    """Cut ``model``'s decoder layers over ``mesh``'s ``tensor`` and
    ``expert`` dims in place (each leaf whose spec names one becomes a new
    parameter holding this rank's slice, with the old one's
    ``requires_grad``), mark every decoder layer with its axes, and return
    (and keep as ``model.shard_cuts``) the cuts by parameter name. A mesh
    with both dims 1 wide changes nothing.

    W8 weights are cut by their float weight's rule (``_w8_spec``). The
    stacked layout's (L, K, N) codes and scales, one pair shared by every
    layer's marker, are cut once, and every marker gets the cut pair; cut
    codes keep the W8 kernels' row pitch (``utils/quantize.
    pitched_codes``)."""
    from kosmosx_torch.parallel.sharding import param_specs
    from kosmosx_torch.utils.quantize import pitched_codes

    tp, ep = mesh_axis(mesh, "tensor"), mesh_axis(mesh, "expert")
    cuts: Dict[str, Cut] = {}
    if tp is None and ep is None:
        return cuts
    by_axis = {"tensor": tp, "expert": ep}
    done: Dict[int, tuple] = {}   # id of a cut leaf -> (it, its cut)
    for prefix, layer in _layer_prefixes(model).items():
        layer.tensor_axis, layer.expert_axis = tp, ep
        for name, spec in param_specs(layer).items():
            slices, groups = [], []
            owner, _, leaf = name.rpartition(".")
            mod = layer.get_submodule(owner) if owner else layer
            p = mod._parameters[leaf]
            if id(p) in done:   # a stacked W8 leaf another layer shares
                mod._parameters[leaf] = done[id(p)][1]
                continue
            spec = _w8_spec(mod, owner, leaf) or spec
            for dim, ax in enumerate(spec):
                axis = by_axis.get(ax)
                if axis is None:
                    continue
                n = p.shape[dim]
                if n % axis.size:
                    raise ValueError(f"{prefix}.{name}: dim {dim} of "
                                     f"{tuple(p.shape)} does not split over "
                                     f"{ax}={axis.size}")
                sl = axis.part(n)
                slices.append((dim, sl.start, sl.stop - sl.start))
                groups.append(axis.group)
            if not slices:
                continue
            piece = p.detach()
            for dim, start, size in slices:
                piece = piece.narrow(dim, start, size)
            piece = piece.contiguous().clone()
            if piece.dtype == torch.int8:
                piece = pitched_codes(piece)
            mod._parameters[leaf] = nn.Parameter(
                piece, requires_grad=p.requires_grad)
            done[id(p)] = (p, mod._parameters[leaf])
            cuts[f"{prefix}.{name}"] = Cut(tuple(p.shape), tuple(slices),
                                           tuple(groups))
    model.shard_cuts = cuts
    return cuts


def mark_batch(model: nn.Module, group) -> None:
    """Mark ``model``'s decoder layers with the process group(s) a
    training batch is split over (``Trainer.batch_group``; empty or None:
    one rank holds it all). An MoE layer's routing loss is then the rank's
    share of the global batch's (``nn/moe._aux_loss``)."""
    from kosmosx_torch.parallel.sharding import decoder_layers

    for layer in decoder_layers(model):
        layer.batch_group = group or None


_MARKS = ("tensor_axis", "expert_axis", "batch_group")


def inherit(src: nn.Module, dst: nn.Module) -> nn.Module:
    """``dst``, a module built from ``src``'s tree (``train/lora.py``'s
    adapted model), marked and cut as ``src`` is."""
    from kosmosx_torch.parallel.sharding import decoder_layers

    first = decoder_layers(src)[:1]
    marks = {k: v for layer in first for k, v in vars(layer).items()
             if k in _MARKS}
    if not marks:
        return dst
    for layer in decoder_layers(dst):
        for k, v in marks.items():
            setattr(layer, k, v)
    dst.shard_cuts = getattr(src, "shard_cuts", {})
    return dst
