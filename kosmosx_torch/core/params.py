"""Parameter trees as ``nn.Module``s whose names are the JAX tree paths.

The JAX package keeps parameters in nested dicts and lists
(``{"decoder": {"layers": [{"attn": {"q": {"A": {"w": ...}}}}]}}``).
``ParamTree`` turns such a tree into modules: a dict becomes a module with one
child or parameter per key, a list an ``nn.ModuleList``. So
``named_parameters()`` yields ``decoder.layers.3.attn.q.A.w`` — the JAX path —
and ``tree["attn"]["q"]`` reads like the JAX code it ports. Weights keep the
JAX layout: linear weights are ``(in, out)`` and are applied as ``x @ w``.

Parameters are created with ``requires_grad=False``, so serving builds no
autograd graph. Training makes them trainable with ``set_trainable``, which
keeps whole top-level subtrees frozen (``TrainConfig.freeze``, e.g. the
CLIP tower ``"clip"``): a frozen subtree takes no gradient, so autograd
saves no activations for its backward.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch
from torch import nn


class ParamTree(nn.Module):
    """A nested dict/list of tensors held as modules and parameters."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v) for v in value))
            elif isinstance(value, torch.Tensor):
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))
            else:
                raise TypeError(f"parameter {key!r}: unsupported leaf "
                                f"{type(value).__name__}")

    def set_trainable(self, freeze: Iterable[str] = ()) -> None:
        """``requires_grad`` on for every parameter outside the top-level
        subtrees named in ``freeze``, off inside them. Raises for a
        ``freeze`` key the tree lacks (as kosmosx_tpu/train/trainer.py:
        241-244)."""
        freeze = tuple(freeze)
        missing = [k for k in freeze if k not in self]
        if missing:
            raise ValueError(f"freeze keys {missing} not in params (have "
                             f"{sorted(self._modules) + sorted(self._parameters)})")
        for name, param in self.named_parameters():
            param.requires_grad_(name.split(".", 1)[0] not in freeze)

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

