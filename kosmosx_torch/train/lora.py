"""LoRA factors over parameter trees, and their training (counterpart of
kosmosx_tpu/train/lora.py).

LoRA factors live inside the parameter tree, at the linear they adapt:
``node["lora"] = {"a": (in, r), "b": (r, out), "scale": ()}``, and
``nn/layers.linear`` adds ``scale * (x @ a) @ b`` to its output, also over
W8 base weights (QLoRA). The port's layers are a per-layer list, so the
factors are per layer too, where JAX stacks them over ``L``.

The functions take a parameter-tree module (``Kosmos``, ``KosmosLanguage``,
``ParamTree``) or its nested dict/list tree and return nested dicts and
lists whose leaves are the input's own tensors (no copy), which every apply
function takes as it takes a module; ``adapted_module`` makes such a tree a
module again. Training the factors (``make_lora_train_step``,
``lora_state``, ``LoraTrainer``) differentiates only them: the base is
frozen, its integer W8 leaves included (QLoRA), and the optimizer holds
state for the factors only.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from kosmosx_torch.core.params import ParamTree, to_tree
from kosmosx_torch.nn import layers
from kosmosx_torch.nn.moe import find_moe_ffn
from kosmosx_torch.parallel.sharding import batch_shards

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
    moe = find_moe_ffn(as_tree(params))
    if moe is not None and {"fc1", "fc2"} & set(targets):
        # JAX's name rule adds factors to the stacked expert fc1/fc2
        # (kosmosx_tpu/train/lora.py:32-44), which its moe_ffn never reads
        raise ValueError(
            f"LoRA on the MoE expert stacks ({moe}.experts): no MoE path "
            f"reads expert factors, so fc1/fc2 targets are refused on a "
            f"model with an MoE decoder, its vision tower's and resampler's "
            f"fc1/fc2 too; target attention only (q, k, v, out)")

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


def adapted_module(base, lora_tree):
    """``base`` (a parameter-tree module) with the factors of ``lora_tree``
    grafted in, as a module of its type on its config: every tensor is
    shared (an ``nn.Parameter`` leaf is registered as itself, so gradients
    of the module's factors are gradients of the tree's)."""
    from kosmosx_torch.parallel.tensor import inherit

    tree = attach_lora(to_tree(base), lora_tree)
    config = getattr(base, "config", None)
    return inherit(base, ParamTree(tree) if config is None else
                   type(base)(config, params=tree))


def _trainable(lora_tree):
    """The tree with every factor an ``nn.Parameter`` that requires grad,
    sharing the input's storage."""
    if isinstance(lora_tree, dict):
        return {k: _trainable(v) for k, v in lora_tree.items()}
    if isinstance(lora_tree, (list, tuple)):
        return [_trainable(v) for v in lora_tree]
    return nn.Parameter(lora_tree.detach(), requires_grad=True)


def make_lora_train_step(loss_fn: Callable, optimizer,
                         reduce_grads: Optional[Callable] = None,
                         shard_index: Optional[int] = None) -> Callable:
    """``step(state, base_params, batch) -> (state, metrics)``
    (kosmosx_tpu/train/lora.py:181-204): ``loss_fn(model, batch, key)``
    over the adapted model (``base_params`` with ``state["lora"]`` grafted
    in), gradients for the factors only (``torch.autograd.grad`` over the
    lora leaves; the base is frozen, so autograd keeps nothing for its
    weight gradients), ``optimizer`` (an ``Optimizer`` or ``MultiSteps``
    over the factors, ``state["opt_state"]``) applied in place, and the
    metrics of ``loss_fn`` plus ``grad_norm`` before clipping. The dropout
    key is drawn from the state's generator, as ``Trainer`` draws it. The
    state is updated in place (``step`` + 1) and returned. Over a mesh
    (``LoraTrainer``), ``reduce_grads`` sums the ranks' factor gradients
    and the key folds in the rank's ``shard_index``."""
    built: Dict[str, Any] = {}

    def train_step(state, base_params, batch):
        if built.get("key") != (id(base_params), id(state["lora"])):
            base_params.requires_grad_(False)
            built.update(key=(id(base_params), id(state["lora"])),
                         refs=(base_params, state["lora"]),
                         model=adapted_module(base_params, state["lora"]),
                         leaves=lora_state_dict(state["lora"]))
        leaves = built["leaves"]
        key = layers.rng_key(state["rng"])
        if shard_index is not None:
            key = layers.fold_in(key, shard_index)
        loss, metrics = loss_fn(built["model"], batch, key)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True)))
        if reduce_grads is not None:
            grads = reduce_grads(grads)
        metrics = dict(metrics)
        metrics["grad_norm"] = optimizer.step(grads)
        state["step"] += 1
        return state, metrics

    return train_step


def lora_state(lora_tree, optimizer: Callable,
               rng: Optional[torch.Generator]) -> Dict[str, Any]:
    """``{"lora", "opt_state", "step", "rng"}``
    (kosmosx_tpu/train/lora.py:207-209): the factors as trainable leaves
    (sharing ``lora_tree``'s storage) and ``optimizer(named factors)``,
    e.g. ``Trainer.build_optimizer``: optimizer state for the factors
    only."""
    lora = _trainable(lora_tree)
    return {"lora": lora, "opt_state": optimizer(lora_state_dict(lora)),
            "step": 0, "rng": rng}


class LoraTrainer:
    """LoRA fine-tuning over a frozen base (kosmosx_tpu/train/lora.py:
    212-330), reusing ``Trainer``'s optimizer, schedule and loop.

    ``init_fn(generator)`` builds the base unless ``base_params`` (a
    parameter-tree module, dense or W8) is given; the factors are drawn
    from the same seeded generator, which then draws the dropout keys.
    ``TrainConfig.freeze`` does not reach the factors: every targeted
    linear, the ViT's too, is adapted, as in JAX. The state is
    ``{"lora", "opt_state", "step", "rng"}``; checkpoints hold it and
    ``cfg.resume`` restores it (``train/checkpoint.py``). Over a mesh the
    base and the factors are replicated on every rank, over ``fsdp`` too
    (the factors are small, and the base is frozen), the batch is split
    over ``data`` x ``fsdp`` and the factors' gradients are all-reduced.
    Over ``tensor`` (and ``expert``) the base's decoder layers are cut
    (``parallel/tensor.shard_model``) after the factors are drawn on the
    whole base; the factors stay whole, each rank applying its part of
    them, and their gradients are whole on every rank."""

    def __init__(self, init_fn: Callable, loss_fn: Callable, cfg, rank: int,
                 *, alpha: Optional[float] = None,
                 targets: Sequence[str] = DEFAULT_TARGETS, mesh=None,
                 base_params=None, device=None):
        from kosmosx_torch.train.trainer import Trainer

        self._t = Trainer(init_fn, loss_fn, cfg, mesh=mesh, device=device)
        self._t.init_state = self.init_state
        self._t._build_step = self._build_step
        self._t.final_params = self._final_params
        self._t.evaluate = self.evaluate
        self.rank, self.alpha, self.targets = rank, alpha, tuple(targets)
        self._given_base = base_params
        self.base_params = None

    @property
    def cfg(self):
        return self._t.cfg

    @property
    def optimizer(self):
        return self._t.optimizer

    @property
    def state(self):
        return self._t.state

    def run(self, batches, steps=None, log_fn=None, eval_batches=None):
        return self._t.run(batches, steps=steps, log_fn=log_fn,
                           eval_batches=eval_batches)

    def place_batch(self, batch):
        return self._t.place_batch(batch)

    def init_state(self) -> Dict[str, Any]:
        t = self._t
        rng = torch.Generator(device=t.device).manual_seed(t.cfg.seed)
        base = self._given_base if self._given_base is not None \
            else t._init_fn(rng)
        base.requires_grad_(False)
        self.base_params = base
        lora_tree = strip_lora(add_lora(rng, base, self.rank,
                                        alpha=self.alpha,
                                        targets=self.targets))[1]
        if t.mesh is not None:
            from kosmosx_torch.parallel.tensor import mark_batch, shard_model

            shard_model(base, t.mesh)
            mark_batch(base, t.batch_group)
        t.state = lora_state(lora_tree, t.build_optimizer, rng)
        t.optimizer = t.state["opt_state"]
        t._step_fn = None
        return t.state

    def _build_step(self) -> Callable:
        t = self._t
        step = make_lora_train_step(
            t._loss_fn, t.optimizer,
            reduce_grads=None if t.mesh is None else t.reduce_grads,
            shard_index=None if t.mesh is None else batch_shards(t.mesh)[0])
        self._t._step_fn = step
        self._t._run_step = lambda batch: step(
            self._t.state, self.base_params, batch)[1]
        return step

    def evaluate(self, eval_batches) -> Dict:
        """Mean loss and metrics over a validation set on the adapted
        model (base + current factors), as ``Trainer.evaluate``."""
        return type(self._t).evaluate(self._t, eval_batches,
                                      model=self.adapted_params())

    def adapted_params(self):
        """The base with the current factors grafted in (unmerged), a
        module sharing both."""
        return adapted_module(self.base_params, self._t.state["lora"])

    def merged_params(self):
        """The base with every delta folded in (``merge_lora``), for
        serving without the factors; raises over W8 bases."""
        with torch.no_grad():
            tree = merge_lora(attach_lora(to_tree(self.base_params),
                                          self._t.state["lora"]))
        return type(self.base_params)(self.base_params.config, params=tree)

    def _final_params(self):
        """The final save: merged where the base can take the deltas, the
        adapted tree over W8 bases (int8 codes cannot take an exact delta;
        ``nn/layers.linear`` applies it at run time)."""
        try:
            return self.merged_params()
        except ValueError:
            return self.adapted_params()
