"""Parameter trees as ``nn.Module``s whose names are the JAX tree paths.

The JAX package keeps parameters in nested dicts and lists
(``{"decoder": {"layers": [{"attn": {"q": {"A": {"w": ...}}}}]}}``).
``ParamTree`` turns such a tree into modules: a dict becomes a module with one
child or parameter per key, a list an ``nn.ModuleList``. So
``named_parameters()`` yields ``decoder.layers.3.attn.q.A.w`` — the JAX path —
and ``tree["attn"]["q"]`` reads like the JAX code it ports. Weights keep the
JAX layout: linear weights are ``(in, out)`` and are applied as ``x @ w``.

Weight-only int8 (W8) trees hold three more kinds of leaf: int8 codes, as
parameters like any other; the stacked (L, …) codes and scales of a
``scan_layers`` decoder, one ``nn.Parameter`` registered in every layer's
tree, so ``named_parameters()`` yields it once, under layer 0's path; and
each layer's index in that stack, an int leaf held as a 0-d int32 buffer on
the device of its siblings (``utils/quantize.py``).

The modality zoo's trees add two shapes: lists of lists (the r3d18 tower's
stages of blocks, an ``nn.ModuleList`` of ``nn.ModuleList``s) and ``None``
for an absent subtree (a block without a downsampling conv), registered as
a ``None`` parameter: ``tree["down"]`` reads ``None`` as in JAX, and
``named_parameters()`` skips it.

Parameters are created with ``requires_grad=False``, so serving builds no
autograd graph. Training makes them trainable with ``set_trainable``, which
keeps whole top-level subtrees frozen (``TrainConfig.freeze``, e.g. the
CLIP tower ``"clip"``): a frozen subtree takes no gradient, so autograd
saves no activations for its backward. Integer leaves (W8 codes) always
stay frozen; a W8 tree trains through LoRA factors (``train/lora.py``).
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
            if isinstance(value, (dict, list, tuple)):
                self.add_module(key, _node(value))
            elif value is None:  # an absent optional subtree
                self.register_parameter(key, None)
            elif isinstance(value, nn.Parameter):  # shared stacked W8 leaf
                self.register_parameter(key, value)
            elif isinstance(value, torch.Tensor):
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, int):  # a W8 marker's layer index
                device = next(v.device for v in tree.values()
                              if isinstance(v, torch.Tensor))
                self.register_buffer(key, torch.tensor(
                    value, dtype=torch.int32, device=device), persistent=False)
            else:
                raise TypeError(f"parameter {key!r}: unsupported leaf "
                                f"{type(value).__name__}")

    def set_trainable(self, freeze: Iterable[str] = ()) -> None:
        """``requires_grad`` on for every parameter outside the top-level
        subtrees named in ``freeze``, off inside them. Raises for a
        ``freeze`` key the tree lacks (as kosmosx_tpu/train/trainer.py:
        241-244). Integer leaves keep ``requires_grad=False``; one outside
        ``freeze`` raises, as ``jax.grad`` over int8 leaves does: a W8 tree
        trains LoRA factors over a frozen base (``train/lora.py``)."""
        freeze = tuple(freeze)
        missing = [k for k in freeze if k not in self]
        if missing:
            raise ValueError(f"freeze keys {missing} not in params (have "
                             f"{sorted(self._modules) + sorted(self._parameters)})")
        trainable = {name: name.split(".", 1)[0] not in freeze
                     for name, _ in self.named_parameters()}
        codes = [name for name, p in self.named_parameters()
                 if trainable[name] and not p.is_floating_point()]
        if codes:
            raise ValueError(
                f"full-parameter training of W8 weights ({codes[0]} and "
                f"{len(codes) - 1} more integer leaves): train LoRA factors "
                f"over the frozen W8 base (train/lora.py, QLoRA)")
        for name, param in self.named_parameters():
            param.requires_grad_(trainable[name])

    def forward(self, fn, *args, **kwargs):
        """``fn(self, *args, **kwargs)``: the functional code runs a subtree
        through the module's ``__call__`` this way (``nn/decoder.py``'s
        layers), so hooks on the subtree run, FSDP2's among them. Models
        override it with their own ``apply``."""
        return fn(self, *args, **kwargs)

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return (key in self._parameters or key in self._modules
                or key in self._buffers)


def _node(value) -> nn.Module:
    """A dict as a ``ParamTree``, a list (of dicts or of lists) as an
    ``nn.ModuleList`` of its elements' nodes."""
    if isinstance(value, dict):
        return ParamTree(value)
    return nn.ModuleList(_node(v) for v in value)


def tree_device(params) -> torch.device:
    """The device of the first tensor of a parameter-tree module or of a
    nested dict/list tree of tensors."""
    if isinstance(params, nn.Module):
        return next(params.parameters()).device
    if isinstance(params, dict):
        return tree_device(next(iter(params.values())))
    if isinstance(params, (list, tuple)):
        return tree_device(params[0])
    return params.device


def to_tree(module: nn.Module) -> Any:
    """The nested dict/list tree of a parameter-tree module, leaves the
    module's own parameters (and layer indices as ints), which ``ParamTree``
    builds the same module from."""
    if isinstance(module, nn.ModuleList):
        return [to_tree(m) for m in module]
    out: Dict[str, Any] = dict(module._parameters)
    out.update({k: int(b) for k, b in module._buffers.items()})
    out.update({k: to_tree(m) for k, m in module._modules.items()})
    return out

