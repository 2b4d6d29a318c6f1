"""Checkpoint save and restore in the port's own format (counterpart of
kosmosx_tpu/train/checkpoint.py:31-84).

A training checkpoint is the directory ``{output_dir}/step_{n}`` holding
``state.pt``: a ``torch.save`` of the parameters (name -> tensor, the JAX
tree paths; for a ``LoraTrainer`` state, the LoRA factors only, under
``lora``), the optimizer state (the 8-bit kinds' codes and scales, and
under gradient accumulation the accumulator and the mini-step), the step
and the generator state, so a resume mid-accumulation continues exactly. A
params-only save (``save_params``) holds ``params.pt``. Directories are the
JAX package's layout, so ``latest_checkpoint`` finds either package's.

The JAX package's orbax checkpoints (kosmosx_tpu/train/checkpoint.py) are
read with ``tensorstore`` alone, never ``orbax`` (which imports ``jax``):
``_METADATA``'s ``tree_metadata`` names every leaf by its keys, and each
leaf is a zarr array in the checkpoint's ``ocdbt`` key-value store at its
keys joined by ``.``. ``restore_params`` reads a params-only checkpoint
(JAX's ``save_params``, ``scripts/import_reference.py``), and
``restore_state_params`` the ``params`` of a ``Trainer`` checkpoint, into
the port's layout (``utils.jax_params.from_jax_params``: stacked layers
sliced into the list, W8 codes at their row pitch). ``restore_checkpoint``
resumes a JAX ``Trainer`` or ``LoraTrainer`` checkpoint: optax's state of
every ``make_optimizer`` kind, under ``MultiSteps`` too, maps onto the
port's optimizer state by parameter name (``optax_state_dict``).
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from kosmosx_torch.core.params import ParamTree

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"
ORBAX_METADATA = "_METADATA"


def _local(t: torch.Tensor) -> torch.Tensor:
    """A parameter's local tensor (an FSDP shard's run)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _params_dict(params, whole: bool = True) -> Dict[str, torch.Tensor]:
    """name -> tensor of a module's parameters (sharing their storage), or
    with ``whole`` each one as a whole tensor: an FSDP shard or a
    ``tensor``/``expert`` cut gathered (``parallel.sharding.whole``, a
    collective: every rank must call it)."""
    if not isinstance(params, torch.nn.Module):
        return dict(params)
    if not whole:
        return {n: p.detach() for n, p in params.named_parameters()}
    from kosmosx_torch.parallel.sharding import param_shards
    from kosmosx_torch.parallel.sharding import whole as gather

    shards = param_shards(params)
    return {n: gather(_local(p.detach()), shards[n])
            for n, p in params.named_parameters()}


def _barrier(group) -> None:
    """Wait for the ranks of ``group`` (a group or a tuple of them)."""
    if group is None:
        return
    import torch.distributed as dist

    for g in group if isinstance(group, tuple) else (group,):
        dist.barrier(group=g)


def _save(obj: Any, path: str, name: str) -> str:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, os.path.join(path, name))
    return path


def _load(path: str, name: str, map_location=None) -> Any:
    file = os.path.join(os.path.abspath(path), name)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no checkpoint at {path} (neither {name} nor "
                                f"an orbax {ORBAX_METADATA})")
    return torch.load(file, map_location=map_location, weights_only=True)


def is_orbax_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, ORBAX_METADATA))


def is_params_checkpoint(path: str) -> bool:
    """Whether ``restore_params`` reads ``path``: the port's ``params.pt``
    or an orbax checkpoint of the JAX package."""
    return os.path.isfile(os.path.join(path, PARAMS_FILE)) or \
        is_orbax_checkpoint(path)


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError("reading an orbax checkpoint of the JAX package "
                          "needs the tensorstore package") from e
    return tensorstore


def _lists(tree) -> Any:
    """A tree keyed by (key, is_index) pairs -> dicts and lists."""
    if not isinstance(tree, dict):
        return tree
    if all(index for _, index in tree):
        return [_lists(tree[k]) for k in sorted(tree)]
    return {key: _lists(v) for (key, _), v in tree.items()}


def read_orbax_tree(path: str, subtree: Optional[str] = None) -> Any:
    """The leaves of an orbax checkpoint as a nested dict/list tree of numpy
    arrays (bf16 leaves as ``ml_dtypes`` bfloat16), read with tensorstore;
    ``subtree`` keeps the leaves under that top-level key (``"params"`` of
    a ``Trainer`` state; where that key is a leaf, the leaf itself). An
    entry that orbax records as no array (its ``value_type`` "None" or
    ``skip_deserialize``: optax's empty states) is ``None`` in the
    tree."""
    ts = _tensorstore()
    path = os.path.abspath(path)
    with open(os.path.join(path, ORBAX_METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3") or not meta.get("use_ocdbt", True):
        raise ValueError(f"{path}: an orbax layout other than zarr over ocdbt "
                         f"(use_zarr3={meta.get('use_zarr3')}, use_ocdbt="
                         f"{meta.get('use_ocdbt')}), which the JAX package "
                         f"does not write")
    context = ts.Context()
    tree: Dict = {}
    for entry in meta["tree_metadata"].values():
        # key_type 1: a sequence index, 2: a dict key
        keys = [(int(k["key"]), True) if k["key_type"] == 1 else
                (k["key"], False) for k in entry["key_metadata"]]
        if subtree is not None:
            if keys[0][0] != subtree:
                continue
            keys = keys[1:]
        meta_value = entry.get("value_metadata", {})
        if meta_value.get("value_type") == "None" \
                or meta_value.get("skip_deserialize"):
            # optax's empty states (clip_by_global_norm's, the masked decay's
            # inner state, MultiSteps' skip_state): written as no array
            value = None
        else:
            name = ".".join(k["key"] for k in entry["key_metadata"])
            kvstore = {"driver": "ocdbt", "base": f"file://{path}/",
                       "path": name}
            value = ts.open({"driver": "zarr", "kvstore": kvstore},
                            context=context).result().read().result()
        if not keys:   # ``subtree`` is a leaf (a state's ``step``)
            return value
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    if not tree:
        raise ValueError(f"{path}: no leaves"
                         + (f" under {subtree!r}" if subtree else ""))
    return _lists(tree)


def _is_codes(node) -> bool:
    """An 8-bit moment's ``{"q", "scale"}`` pair of arrays."""
    return isinstance(node, dict) and set(node) == {"q", "scale"} \
        and not any(isinstance(v, (dict, list)) for v in node.values())


def _has_codes(tree) -> bool:
    if _is_codes(tree):
        return True
    values = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    return any(_has_codes(v) for v in values)


def _by_name(tree) -> Dict[str, torch.Tensor]:
    """name -> tensor of a JAX tree that mirrors the parameters (LoRA
    factors, optax's float moments and accumulator), named as the port's
    parameters are: ``from_jax_params``' walk (stacked layers sliced into
    the list), flattened as ``ParamTree`` names it; ``None`` (an empty
    state) gives nothing."""
    from kosmosx_torch.utils.jax_params import from_jax_params

    return {n: p.detach() for n, p in
            ParamTree(from_jax_params(tree, "cpu")).named_parameters()}


def _codes(tree, part: str, numel: Dict[str, int], path: str = "",
           stacked: bool = False) -> Any:
    """The ``part`` ("q" or "scale") of every 8-bit ``{"q", "scale"}`` pair
    of a moment tree, as a tree ``_by_name`` takes (kept away from
    ``from_jax_params``' W8 handling of ``{"q", "scale"}`` leaves). Under a
    stacked ``layers`` dict a pair's blocks run over the whole stack: they
    are reshaped to (L, blocks a layer, ...), so each layer gets its own,
    which holds only where a layer's elements (``numel``, by the port's
    names) fill whole blocks."""
    from kosmosx_torch.train.quant import BLOCK

    if _is_codes(tree):
        x = tree[part]
        if not stacked:
            return x
        n = numel[path]
        if n % BLOCK:
            raise ValueError(
                f"{path}: the checkpoint's 8-bit moments of the stacked "
                f"layers run across layer boundaries ({n} elements a layer, "
                f"blocks of {BLOCK}); the port keeps each layer's own blocks")
        return x.reshape(-1, n // BLOCK, *x.shape[1:])
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            name = f"{path}.{k}" if path else str(k)
            if k == "layers" and isinstance(v, dict):   # named as layer 0
                out[k] = _codes(v, part, numel, f"{name}.0", True)
            else:
                out[k] = _codes(v, part, numel, name, stacked)
        return out
    if isinstance(tree, (list, tuple)):
        return [_codes(v, part, numel, f"{path}.{i}", stacked)
                for i, v in enumerate(tree)]
    return tree


# optax's chain states of kosmosx_tpu/train/optim.make_optimizer (:130-162):
# optax.lion and optax.adamw are chains of (the moments, the masked decay's
# empty state, scale_by_schedule's count); stable_adamw and the 8-bit kinds
# (kosmosx_tpu/train/quant.py:60-149) are one state of count, mu and nu;
# clip_by_global_norm's state is empty; optax.MultiSteps wraps the chain
# with mini_step, gradient_step and acc_grads (kosmosx_tpu/train/
# trainer.py:218)


def _moments_node(tree) -> Tuple[Dict[str, Any], bool]:
    """(the state holding ``mu``, whether it sits in an optax chain of
    three: ``optax.lion`` or ``optax.adamw``) of an optax state tree."""
    found = []

    def walk(node, parent):
        if isinstance(node, dict) and "mu" in node:
            found.append((node, parent))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v, node)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, node)

    walk(tree, None)
    if len(found) != 1:
        raise ValueError(f"an optax state with {len(found)} moment states; "
                         f"the JAX package's optimizers hold one")
    node, parent = found[0]
    chained = isinstance(parent, list) and len(parent) == 3 \
        and parent[0] is node
    return node, chained


def optax_kind(tree) -> str:
    """The ``make_optimizer`` name of an optax state (read from a JAX
    checkpoint's ``opt_state``), with " under MultiSteps" for
    ``optax.MultiSteps``."""
    multi = isinstance(tree, dict) and "mini_step" in tree
    node, chained = _moments_node(tree["inner_opt_state"] if multi else tree)
    if _has_codes(node["mu"]):
        name = "lion8bit" if node.get("nu") is None else "adamw8bit"
    elif "nu" not in node:
        name = "lion"
    else:
        name = "adamw" if chained else "stable_adamw"
    return name + (" under MultiSteps" if multi else "")


def _port_kind(opt) -> str:
    from kosmosx_torch.train.optim import MultiSteps

    if isinstance(opt, MultiSteps):
        return opt.inner.name + " under MultiSteps"
    return opt.name


def optax_state_dict(tree, opt) -> Dict[str, Any]:
    """A JAX checkpoint's optax state (``read_orbax_tree``'s
    ``opt_state``) as ``opt.state_dict()`` gives the port's, for
    ``opt.load_state_dict``: the count and moments of the chain by the
    parameter names of ``opt`` (8-bit moments as their codes and scales),
    and under ``MultiSteps`` the counters and the accumulator. Raises a
    ``ValueError`` naming both where the checkpoint's optimizer is not
    ``opt``'s kind."""
    from kosmosx_torch.train.optim import MultiSteps

    kind, want = optax_kind(tree), _port_kind(opt)
    if kind != want:
        raise ValueError(f"the checkpoint's optimizer is {kind}, the run's "
                         f"is {want}")
    inner = opt.inner if isinstance(opt, MultiSteps) else opt
    numel = {n: inner.shards[n].numel if inner.shards[n] is not None
             else p.numel() for n, p in inner.params.items()}

    def by_name(sub, slot):
        if _has_codes(sub):
            q, scale = (_by_name(_codes(sub, part, numel))
                        for part in ("q", "scale"))
            got = {n: {"q": q[n], "scale": scale[n]} for n in q}
        else:
            got = _by_name(sub)
        if set(got) != set(numel):
            missing = sorted(set(numel) - set(got))[:5]
            extra = sorted(set(got) - set(numel))[:5]
            raise ValueError(f"the checkpoint's {slot} does not match the "
                             f"parameters: missing {missing}, unexpected "
                             f"{extra}")
        return got

    multi = isinstance(opt, MultiSteps)
    node, _ = _moments_node(tree["inner_opt_state"] if multi else tree)
    state = {"count": int(node["count"]), "mu": by_name(node["mu"], "mu"),
             "nu": by_name(node["nu"], "nu") if node.get("nu") is not None
             else {}}
    if not multi:
        return state
    mini = int(tree["mini_step"])
    return {"mini_step": mini, "gradient_step": int(tree["gradient_step"]),
            "acc": by_name(tree["acc_grads"], "acc_grads") if mini else None,
            "inner": state}


def _orbax_keys(path: str) -> set:
    with open(os.path.join(path, ORBAX_METADATA)) as f:
        return {e["key_metadata"][0]["key"]
                for e in json.load(f)["tree_metadata"].values()}


def read_orbax_params(path: str, device="cpu") -> Dict[str, Any]:
    """The parameters of an orbax checkpoint of the JAX package, a
    params-only save or a ``Trainer`` state (its ``params``), as the port's
    parameter tree on ``device`` (``from_jax_params``'s layout), which
    ``Kosmos(params=...)`` and ``KosmosLanguage(params=...)`` take."""
    from kosmosx_torch.utils.jax_params import from_jax_params

    subtree = "params" if {"params", "opt_state"} <= _orbax_keys(path) \
        else None
    return from_jax_params(read_orbax_tree(path, subtree), device)


def _orbax_named_params(path: str) -> Dict[str, torch.Tensor]:
    """An orbax checkpoint's parameters by the port's parameter names."""
    return {n: p.detach() for n, p in
            ParamTree(read_orbax_params(path)).named_parameters()}


def _tensors(state: Dict[str, Any], whole: bool = True
             ) -> Tuple[str, Dict[str, torch.Tensor]]:
    """(key, name -> tensor) of a state's trained tensors: ``params`` of a
    ``Trainer`` state (``whole`` as ``_params_dict``), or the factors of a
    ``LoraTrainer`` one."""
    if "lora" in state:
        from kosmosx_torch.train.lora import lora_state_dict

        return "lora", {n: t.detach()
                        for n, t in lora_state_dict(state["lora"]).items()}
    return "params", _params_dict(state["params"], whole)


def save_checkpoint(state: Dict[str, Any], output_dir: str, step: int, *,
                    writer: bool = True, group=None) -> str:
    """Save a ``Trainer`` state (``params`` module, ``opt_state``
    optimizer, ``step``, ``rng`` generator) or a ``LoraTrainer`` one
    (``lora`` factors in place of ``params``) to
    ``{output_dir}/step_{step}``. Over a mesh every rank calls it (sharded
    parameters and optimizer state are gathered into the single-process
    format), only the ``writer`` writes, and the ranks of ``group`` wait
    for it."""
    rng = state.get("rng")
    key, tensors = _tensors(state)
    opt = state["opt_state"].state_dict()
    path = os.path.abspath(os.path.join(output_dir, f"step_{step}"))
    if writer:
        _save({key: tensors, "opt_state": opt, "step": int(state["step"]),
               "rng": None if rng is None else rng.get_state()},
              path, STATE_FILE)
        logger.info("saved checkpoint %s", path)
    _barrier(group)
    return path


def latest_checkpoint(output_dir: str) -> Optional[Tuple[str, int]]:
    """``(path, step)`` of the newest ``step_*`` directory, or None."""
    if not os.path.isdir(output_dir):
        return None
    best = None
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            step = int(m.group(1))
            if best is None or step > best[1]:
                best = (os.path.join(output_dir, name), step)
    return best


def restore_checkpoint(path: str, target: Dict[str, Any]) -> Dict[str, Any]:
    """Load a checkpoint into ``target``, a ``Trainer`` or ``LoraTrainer``
    state of the same structure: parameters (or factors) and optimizer
    state are copied in place onto their devices. Returns ``target``.

    A ``Trainer`` or ``LoraTrainer`` checkpoint of the JAX package (orbax)
    resumes too (``_restore_orbax``)."""
    if is_orbax_checkpoint(path):
        return _restore_orbax(path, target)
    saved = _load(path, STATE_FILE, map_location="cpu")
    key, own = _tensors(target, whole=False)
    if key not in saved:
        raise ValueError(f"{path} holds no {key!r}: a checkpoint of "
                         f"{'a LoRA' if key == 'params' else 'a full'} run")
    _copy_into(own, saved[key], target.get("params"))
    target["opt_state"].load_state_dict(saved["opt_state"])
    target["step"] = saved["step"]
    if saved["rng"] is not None and target.get("rng") is not None:
        target["rng"].set_state(saved["rng"])
    return target


def _restore_orbax(path: str, target: Dict[str, Any]) -> Dict[str, Any]:
    """``restore_checkpoint`` of a JAX ``Trainer`` state (``{"params",
    "opt_state", "step", "rng"}``, kosmosx_tpu/train/trainer.py:100-102)
    or ``LoraTrainer`` one (``"lora"`` in place of ``"params"``,
    kosmosx_tpu/train/lora.py:207-209): the parameters or factors by
    name, optax's state through ``optax_state_dict``, the step. A JAX key
    cannot become a torch stream: the generator is seeded from the key's
    two words, so dropout after the resume is not JAX's."""
    key, own = _tensors(target, whole=False)
    keys = _orbax_keys(path)
    if key not in keys:
        raise ValueError(f"{path} holds no {key!r}: a checkpoint of "
                         f"{'a LoRA' if key == 'params' else 'a full'} run")
    if key == "params":
        tensors = _orbax_named_params(path)
    else:
        tensors = _by_name(read_orbax_tree(path, "lora"))
    state = optax_state_dict(read_orbax_tree(path, "opt_state"),
                             target["opt_state"])
    _copy_into(own, tensors, target.get("params"))
    target["opt_state"].load_state_dict(state)
    target["step"] = int(read_orbax_tree(path, "step"))
    if "rng" in keys and target.get("rng") is not None:
        words = [int(w) for w in
                 read_orbax_tree(path, "rng").astype("uint32").reshape(-1)]
        target["rng"].manual_seed((words[0] << 32) | words[-1])
    return target


def restore_state_params(path: str, target: torch.nn.Module) -> torch.nn.Module:
    """The parameters of a ``Trainer`` checkpoint (``save_checkpoint``'s
    directory, or the JAX package's orbax one) loaded into ``target`` in
    place, for inference; returns ``target``."""
    load_params(target, _orbax_named_params(path) if is_orbax_checkpoint(path)
                else _load(path, STATE_FILE, map_location="cpu")["params"])
    return target


def load_params(module: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy ``params`` (name -> tensor) into ``module``'s parameters in
    place; the names must match exactly. Over a mesh each rank keeps its
    piece of each whole tensor."""
    _copy_into(dict(module.named_parameters()), params, module)


def _copy_into(own: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], module=None) -> None:
    if set(own) != set(params):
        missing = sorted(set(own) - set(params))[:5]
        extra = sorted(set(params) - set(own))[:5]
        raise ValueError(f"checkpoint parameters do not match the model: "
                         f"missing {missing}, unexpected {extra}")
    from kosmosx_torch.parallel.sharding import local_piece, param_shards

    shards = param_shards(module) if isinstance(module, torch.nn.Module) \
        else {}
    with torch.no_grad():
        for n, t in params.items():
            local = _local(own[n])
            local.copy_(local_piece(t.to(local.device), shards.get(n),
                                    local.shape))


def save_params(params, path: str, *, writer: bool = True, group=None) -> str:
    """Params-only save (the reference's ``final_model.pt``); over a mesh
    as ``save_checkpoint``."""
    tensors = _params_dict(params)
    path = os.path.abspath(path)
    if writer:
        _save(tensors, path, PARAMS_FILE)
        logger.info("saved params %s", path)
    _barrier(group)
    return path


def restore_params(path: str, target: Optional[torch.nn.Module] = None):
    """The params of a ``save_params`` directory, the port's or the JAX
    package's (orbax): loaded into ``target`` in place and returned, or,
    with no target, as a dict name -> tensor."""
    params = _orbax_named_params(path) if is_orbax_checkpoint(path) else \
        _load(path, PARAMS_FILE, map_location="cpu")
    if target is None:
        return params
    load_params(target, params)
    return target
