"""Parameter counts and paths (counterpart of kosmosx_tpu/utils/pytree.py),
over a parameter-tree module or a nested dict/list tree of tensors. An
absent subtree (``None``) holds nothing."""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import torch
from torch import nn


def _leaves(tree) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, nn.Module):
        yield from tree.named_parameters()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from ((f"{k}.{n}" if n else str(k), x)
                        for n, x in _leaves(v))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from ((f"{i}.{n}" if n else str(i), x)
                        for n, x in _leaves(v))
    elif tree is not None:
        yield "", tree


def param_count(tree: Any) -> int:
    return sum(x.numel() for _, x in _leaves(tree))


def param_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for _, x in _leaves(tree))


def tree_paths(tree: Any):
    """Yield ('/'.join(path), leaf) pairs, JAX's path format."""
    for name, leaf in _leaves(tree):
        yield name.replace(".", "/"), leaf
