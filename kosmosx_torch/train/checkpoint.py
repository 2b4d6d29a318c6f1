"""Checkpoint save and restore in the port's own format (counterpart of
kosmosx_tpu/train/checkpoint.py:31-84).

A training checkpoint is the directory ``{output_dir}/step_{n}`` holding
``state.pt``: a ``torch.save`` of the parameters (name -> tensor, the JAX
tree paths; for a ``LoraTrainer`` state, the LoRA factors only, under
``lora``), the optimizer state (the 8-bit kinds' codes and scales, and
under gradient accumulation the accumulator and the mini-step), the step
and the generator state, so a resume mid-accumulation continues exactly. A
params-only save (``save_params``) holds ``params.pt``. Directories are the
JAX package's layout, so ``latest_checkpoint`` finds either package's; the
JAX package's orbax checkpoints are not read yet and raise.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from kosmosx_torch.core.config import not_ported

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"


def _params_dict(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return {n: p.detach() for n, p in params.named_parameters()}
    return dict(params)


def _save(obj: Any, path: str, name: str) -> str:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, os.path.join(path, name))
    return path


def _load(path: str, name: str, map_location=None) -> Any:
    path = os.path.abspath(path)
    file = os.path.join(path, name)
    if not os.path.isfile(file):
        if os.path.isdir(path) and os.listdir(path):
            raise not_ported(f"reading {path} (no {name}: an orbax checkpoint "
                             f"of the JAX package?)", "Queue 1 item 9")
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(file, map_location=map_location, weights_only=True)


def _tensors(state: Dict[str, Any]) -> Tuple[str, Dict[str, torch.Tensor]]:
    """(key, name -> tensor) of a state's trained tensors: ``params`` of a
    ``Trainer`` state, or the factors of a ``LoraTrainer`` one."""
    if "lora" in state:
        from kosmosx_torch.train.lora import lora_state_dict

        return "lora", {n: t.detach()
                        for n, t in lora_state_dict(state["lora"]).items()}
    return "params", _params_dict(state["params"])


def save_checkpoint(state: Dict[str, Any], output_dir: str, step: int) -> str:
    """Save a ``Trainer`` state (``params`` module, ``opt_state``
    optimizer, ``step``, ``rng`` generator) or a ``LoraTrainer`` one
    (``lora`` factors in place of ``params``) to
    ``{output_dir}/step_{step}``."""
    rng = state.get("rng")
    key, tensors = _tensors(state)
    path = _save({key: tensors,
                  "opt_state": state["opt_state"].state_dict(),
                  "step": int(state["step"]),
                  "rng": None if rng is None else rng.get_state()},
                 os.path.join(output_dir, f"step_{step}"), STATE_FILE)
    logger.info("saved checkpoint %s", path)
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
    their devices. Returns ``target``."""
    saved = _load(path, STATE_FILE, map_location="cpu")
    key, own = _tensors(target)
    if key not in saved:
        raise ValueError(f"{path} holds no {key!r}: a checkpoint of "
                         f"{'a LoRA' if key == 'params' else 'a full'} run")
    _copy_into(own, saved[key])
    target["opt_state"].load_state_dict(saved["opt_state"])
    target["step"] = saved["step"]
    if saved["rng"] is not None and target.get("rng") is not None:
        target["rng"].set_state(saved["rng"])
    return target


def restore_state_params(path: str, target: torch.nn.Module) -> torch.nn.Module:
    """The parameters of a ``Trainer`` checkpoint (``save_checkpoint``'s
    directory) loaded into ``target`` in place, for inference; returns
    ``target``."""
    load_params(target, _load(path, STATE_FILE, map_location="cpu")["params"])
    return target


def load_params(module: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy ``params`` (name -> tensor) into ``module``'s parameters in
    place; the names must match exactly."""
    _copy_into(dict(module.named_parameters()), params)


def _copy_into(own: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor]) -> None:
    if set(own) != set(params):
        missing = sorted(set(own) - set(params))[:5]
        extra = sorted(set(params) - set(own))[:5]
        raise ValueError(f"checkpoint parameters do not match the model: "
                         f"missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for n, t in params.items():
            own[n].copy_(t)


def save_params(params, path: str) -> str:
    """Params-only save (the reference's ``final_model.pt``)."""
    path = _save(_params_dict(params), path, PARAMS_FILE)
    logger.info("saved params %s", path)
    return path


def restore_params(path: str, target: Optional[torch.nn.Module] = None):
    """The params of a ``save_params`` directory: loaded into ``target`` in
    place and returned, or, with no target, as a dict name -> tensor."""
    params = _load(path, PARAMS_FILE, map_location="cpu")
    if target is None:
        return params
    load_params(target, params)
    return target
