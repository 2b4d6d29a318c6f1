"""Weight bridge: a JAX parameter pytree (numpy leaves) -> this package's
parameter tree, mapped by tree path, and back (``to_numpy_params``).

The result is the nested dict/list that ``Kosmos(params=...)``,
``KosmosLanguage(params=...)`` and ``ParamTree`` take; each parameter keeps
its JAX path as its name. Linear weights stay ``(in, out)``, so every leaf is
a plain copy. Three layouts are handled:

- multiway ``{"A", "B"}`` experts, which are ordinary subtrees;
- the list layer layout (``scan_layers=False``);
- the stacked ``(L, ...)`` layout of ``scan_layers=True``
  (kosmosx_tpu/nn/decoder.py:225-228): a ``layers`` entry that is a dict of
  stacked leaves is sliced into a list of per-layer trees.

Weight-only int8 ``{"q", "scale"}`` leaves keep their int8 codes and fp32
scales. In the stacked layout a W8 leaf stays whole, (L, K, N) codes and
(L, 1, N) scales held once, and every layer gets the marker ``{"q",
"scale", "layer": i}``, as ``_graft_stacked_w8`` grafts it
(kosmosx_tpu/nn/decoder.py:292-305). The 2-D codes of a W8 linear weight
get the padded row pitch of ``utils.quantize.pitched_codes`` on ``device``,
as ``quantize_params_w8`` makes them. LoRA factors (``lora`` subtrees,
``train/lora.py``) carry across like any other leaves, sliced per layer in
the stacked layout. ``from_jax_caches`` carries a JAX KV cache across the
same way. The modality zoo's lists of lists and ``None`` subtrees carry
across as they are, and ``to_numpy_params`` gives them back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from kosmosx_torch.utils.quantize import pitched_codes


def _leaf(x, device) -> torch.Tensor:
    # None: an absent subtree; a tensor or an int: a W8 marker's shared leaves
    if x is None or isinstance(x, (torch.Tensor, int)):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _is_w8(tree: Any) -> bool:
    return isinstance(tree, dict) and "q" in tree and "scale" in tree


def _unstack(tree: Any, i: int, shared: dict, device) -> Any:
    """Layer ``i`` of a stacked tree; a stacked W8 leaf becomes the marker of
    its one pair of parameters (kept in ``shared``) and the index."""
    if _is_w8(tree):
        if id(tree) not in shared:
            shared[id(tree)] = {k: nn.Parameter(_leaf(tree[k], device),
                                                requires_grad=False)
                                for k in ("q", "scale")}
        return dict(shared[id(tree)], layer=i)
    if isinstance(tree, dict):
        return {k: _unstack(v, i, shared, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unstack(v, i, shared, device) for v in tree]
    return np.asarray(tree)[i]


def _num_layers(tree: Any) -> int:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return np.asarray(tree).shape[0]


def from_jax_params(tree: Any, device=None, _path: str = "") -> Any:
    """Convert ``tree`` (dicts, lists and array leaves) to torch tensors on
    ``device``, slicing stacked layer stacks into per-layer lists."""
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            path = f"{_path}.{key}" if _path else key
            if key == "layers" and isinstance(value, dict):
                shared: dict = {}
                value = [_unstack(value, i, shared, device)
                         for i in range(_num_layers(value))]
            out[key] = from_jax_params(value, device, path)
            if key == "w" and _is_w8(value) and out[key]["q"].ndim == 2:
                out[key]["q"] = pitched_codes(out[key]["q"])
        return out
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device, f"{_path}.{i}")
                for i, v in enumerate(tree)]
    return _leaf(tree, device)


def from_jax_caches(caches: Any, device=None) -> list:
    """A JAX KV-cache tree (``kosmosx_tpu/nn/decoder.py::init_cache`` and
    what the layers return) -> this package's per-layer list of dicts of
    tensors on ``device``. Takes the list layout and the stacked one (a dict
    of (L, B, H, S, hd|1) leaves), bf16 or fp32 caches and int8 codes with
    fp32 scales."""
    if isinstance(caches, dict):
        caches = [{k: np.asarray(v)[i] for k, v in caches.items()}
                  for i in range(_num_layers(caches))]
    return [{k: _leaf(v, device) for k, v in c.items()} for c in caches]


def to_numpy_params(module: torch.nn.Module) -> Any:
    """The inverse of ``from_jax_params``: a parameter-tree module -> nested
    dicts (and lists for ``ModuleList`` layer stacks) of numpy arrays, keyed
    by JAX tree path, so a model's parameters compare leaf by leaf with a
    JAX pytree. bf16 leaves come back as float32, int8 codes as int8."""
    if isinstance(module, torch.nn.ModuleList):
        return [to_numpy_params(m) for m in module]
    out = {name: None if p is None else
           (p.detach().float() if p.is_floating_point() else p.detach())
           .cpu().numpy() for name, p in module._parameters.items()}
    out.update({name: to_numpy_params(m) for name, m in module._modules.items()})
    return out
