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
sliced into the list, W8 codes at their row pitch). Resuming training from
one (optax's ``opt_state``) is not ported and raises.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from kosmosx_torch.core.config import not_ported
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
    a ``Trainer`` state)."""
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
        name = ".".join(k["key"] for k in entry["key_metadata"])
        kvstore = {"driver": "ocdbt", "base": f"file://{path}/", "path": name}
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = ts.open({"driver": "zarr", "kvstore": kvstore},
                                 context=context).result().read().result()
    if not tree:
        raise ValueError(f"{path}: no leaves"
                         + (f" under {subtree!r}" if subtree else ""))
    return _lists(tree)


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
    """Load a checkpoint into ``target``, a ``Trainer`` state of the same
    structure: parameters and optimizer state are copied in place onto
    their devices. Returns ``target``. A ``Trainer`` checkpoint of the JAX
    package raises: resuming its optax state is not ported (its
    parameters load with ``restore_state_params``)."""
    if is_orbax_checkpoint(path):
        raise not_ported(f"resuming from {path}, an orbax checkpoint of the "
                         f"JAX package (its optax opt_state)",
                         "Queue 1 item 11")
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
