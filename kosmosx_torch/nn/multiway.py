"""Two-expert multiway routing (kosmosx_tpu/nn/multiway.py).

Every projection and LayerNorm inside a multiway layer has experts "A" and
"B"; a static position ``split`` routes positions below it through A and the
rest through B. The decoder and Kosmos never set a split, so everything goes
through A (kosmosx_tpu/nn/multiway.py:33-50), while B's parameters exist for
checkpoint layout.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def init_multiway(multiway: bool, gen, init_fn: Callable, *args, **kwargs):
    """Parameters of one module, duplicated into {"A", "B"} when multiway."""
    if not multiway:
        return init_fn(gen, *args, **kwargs)
    return {"A": init_fn(gen, *args, **kwargs),
            "B": init_fn(gen, *args, **kwargs)}


def multiway_apply(multiway: bool, apply_fn: Callable, params,
                   x: torch.Tensor, split: Optional[int] = None,
                   *args, **kwargs) -> torch.Tensor:
    if not multiway:
        return apply_fn(params, x, *args, **kwargs)
    if split is None or split <= 0 or split >= x.shape[1]:
        return apply_fn(params["A"], x, *args, **kwargs)
    ya = apply_fn(params["A"], x[:, :split], *args, **kwargs)
    yb = apply_fn(params["B"], x[:, split:], *args, **kwargs)
    return torch.cat([ya, yb], dim=1)
