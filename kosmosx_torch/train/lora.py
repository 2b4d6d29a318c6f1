"""LoRA factors over parameter trees: the inference half
(counterpart of kosmosx_tpu/train/lora.py:39-180).

LoRA factors live inside the parameter tree, at the linear they adapt:
``node["lora"] = {"a": (in, r), "b": (r, out), "scale": ()}``, and
``nn/layers.linear`` adds ``scale * (x @ a) @ b`` to its output, also over
W8 base weights (QLoRA). The port's layers are a per-layer list, so the
factors are per layer too, where JAX stacks them over ``L``.

The functions take a parameter-tree module (``Kosmos``, ``KosmosLanguage``,
``ParamTree``) or its nested dict/list tree and return nested dicts and
lists whose leaves are the input's own tensors (no copy), which every apply
function takes as it takes a module. Training the factors
(``make_lora_train_step``, ``lora_state``, ``LoraTrainer``) is not ported
yet and raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from kosmosx_torch.core.config import not_ported

DEFAULT_TARGETS = ("q", "k", "v", "out", "fc1", "fc2")
ALL_TARGETS = DEFAULT_TARGETS + ("out_proj", "image_proj", "to_q", "to_kv",
                                 "to_out")


def as_tree(node: Any) -> Any:
    """A parameter-tree module as nested dicts and lists of its own tensors
    (a W8 marker's layer index stays the 0-d tensor the kernels take);
    dicts and lists are walked the same way."""
    if isinstance(node, nn.ModuleList):
        return [as_tree(m) for m in node]
    if isinstance(node, nn.Module):
        out: Dict[str, Any] = dict(node._parameters)
        out.update(node._buffers)
        out.update({k: as_tree(m) for k, m in node._modules.items()})
        return out
    if isinstance(node, dict):
        return {k: as_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [as_tree(v) for v in node]
    return node


def _is_lora(node: Any) -> bool:
    return isinstance(node, dict) and isinstance(node.get("lora"), dict) \
        and "a" in node["lora"]


def _effective_name(path: Tuple) -> str:
    """The name of the linear a node belongs to; multiway experts A/B are
    transparent (``attn.out.A`` is the ``out`` projection)."""
    names = [p for p in path if isinstance(p, str) and p not in ("A", "B")]
    return names[-1] if names else ""


def add_lora(generator: torch.Generator, params, rank: int, *,
             alpha: Optional[float] = None,
             targets: Sequence[str] = DEFAULT_TARGETS,
             dtype=torch.float32) -> Any:
    """``params`` with LoRA factors in every targeted linear: ``a`` ~ N(0,
    1/rank) drawn from ``generator`` in tree order, ``b`` = 0 (the adapted
    model is the base model), ``scale`` = alpha / rank (alpha defaults to
    rank). The factors lie on the device of their base weight."""
    if rank <= 0:
        raise ValueError(f"rank must be positive, got {rank}")
    scale_val = (alpha if alpha is not None else float(rank)) / float(rank)
    targets = tuple(targets)

    def rec(node, path):
        if isinstance(node, dict):
            w = node.get("w")
            is_w8 = isinstance(w, dict) and "q" in w
            if (w is not None and _effective_name(path) in targets
                    and (is_w8 or getattr(w, "ndim", 0) == 2)):
                arr = w["q"] if is_w8 else w
                din, dout = arr.shape[-2:]
                dev = arr.device
                a = torch.randn((din, rank), generator=generator,
                                device=generator.device, dtype=dtype)
                a = (a / math.sqrt(rank)).to(dev)
                return {**node, "lora": {
                    "a": a, "b": torch.zeros((rank, dout), dtype=dtype,
                                             device=dev),
                    "scale": torch.full((), scale_val, dtype=dtype,
                                        device=dev)}}
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v, path + (i,)) for i, v in enumerate(node)]
        return node

    return rec(as_tree(params), ())


def strip_lora(params) -> Tuple[Any, Any]:
    """An adapted tree -> (base tree, lora tree). The lora tree mirrors the
    structure with only the ``lora`` nodes (empty dicts keep list
    positions), so ``attach_lora(base, lora_tree)`` rebuilds the input."""

    def rec(node):
        if _is_lora(node):
            return {k: v for k, v in node.items() if k != "lora"}, \
                {"lora": node["lora"]}
        if isinstance(node, dict):
            pairs = {k: rec(v) for k, v in node.items()}
            lora = {k: lt for k, (_, lt) in pairs.items() if lt is not None}
            return {k: b for k, (b, _) in pairs.items()}, (lora or None)
        if isinstance(node, list):
            pairs = [rec(v) for v in node]
            base = [b for b, _ in pairs]
            if any(lt is not None for _, lt in pairs):
                return base, [lt if lt is not None else {} for _, lt in pairs]
            return base, None
        return node, None

    base, lora = rec(as_tree(params))
    return base, (lora or {})


def attach_lora(base_params, lora_tree) -> Any:
    """The inverse of ``strip_lora``: ``base_params`` with the lora nodes
    of ``lora_tree`` grafted in (the base's tensors are shared)."""

    def rec(node, lnode):
        if lnode is None or (isinstance(lnode, dict) and not lnode):
            return node
        if _is_lora(lnode):
            return {**node, "lora": lnode["lora"]}
        if isinstance(node, dict):
            return {k: rec(v, lnode.get(k)) if isinstance(lnode, dict) else v
                    for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v, lnode[i]) for i, v in enumerate(node)]
        return node

    return rec(as_tree(base_params), lora_tree)


def merge_lora(params) -> Any:
    """Every ``lora`` node folded into its base weight (``w += scale * a @
    b``) and dropped. W8 base weights cannot take the delta exactly and
    raise: serve them unmerged."""

    def rec(node):
        if _is_lora(node):
            w = node["w"]
            if isinstance(w, dict):
                raise ValueError(
                    "cannot merge LoRA into int8 (W8) base weights; serve "
                    "unmerged (nn/layers.linear applies the delta) or "
                    "dequantize first")
            lora = node["lora"]
            new = {k: v for k, v in node.items() if k != "lora"}
            new["w"] = w + (lora["scale"] * (lora["a"] @ lora["b"])).to(w.dtype)
            return new
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v) for v in node]
        return node

    return rec(as_tree(params))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def num_lora_params(lora_tree) -> int:
    return sum(t.numel() for t in _leaves(lora_tree))


def lora_state_dict(lora_tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A lora tree as ``{dotted path: tensor}`` (list positions as
    integers), the form ``train/checkpoint.save_params`` writes."""
    out: Dict[str, torch.Tensor] = {}
    if isinstance(lora_tree, dict):
        items = lora_tree.items()
    elif isinstance(lora_tree, (list, tuple)):
        items = enumerate(lora_tree)
    else:
        return {prefix: lora_tree}
    for k, v in items:
        out.update(lora_state_dict(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def lora_from_state_dict(flat: Dict[str, torch.Tensor]) -> Any:
    """The inverse of ``lora_state_dict``: integer path parts become list
    positions (missing ones empty dicts, as ``strip_lora`` keeps them)."""
    root: Dict[str, Any] = {}
    for name, t in flat.items():
        node = root
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node.get(str(i), {}) for i in range(max(map(int, node)) + 1)]
        return node

    return listify(root)


def make_lora_train_step(*args, **kwargs):
    raise not_ported("LoRA training (make_lora_train_step)", "Queue 1 item 6c")


def lora_state(*args, **kwargs):
    raise not_ported("LoRA training (lora_state)", "Queue 1 item 6c")


class LoraTrainer:
    """LoRA fine-tuning (kosmosx_tpu/train/lora.py:183-): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise not_ported("LoRA training (LoraTrainer)", "Queue 1 item 6c")
