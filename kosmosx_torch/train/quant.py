"""Blockwise-int8 optimizer moments (counterpart of
kosmosx_tpu/train/quant.py:29-54).

A moment leaf is stored as int8 codes (signed, over +-127) or uint8 codes
(unsigned, over 0..255) in blocks of 256 elements of the flattened leaf,
zero-padded at its end, with one fp32 absmax scale per block; a block whose
absmax is 0 gets scale 1. The codes and scales are bit-identical to the JAX
package's: ``absmax / 127`` and ``absmax / 255`` divide by a device tensor
(``utils/quantize._div127``, ``_div255``), since the card divides by a
Python scalar as a product with its reciprocal, and ``torch.round`` rounds
half to even as ``jnp.round`` does. Blocks run over one leaf at a time, so
a decoder with per-layer leaves (``scan_layers=False`` in JAX) has the same
blocks in both packages.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from kosmosx_torch.utils.quantize import _div127, _div255

BLOCK = 256


def quantize_blockwise(x: torch.Tensor, *, signed: bool = True,
                       block: int = BLOCK) -> Dict[str, torch.Tensor]:
    """A tensor -> ``{"q": int8 or uint8 (nblocks, block), "scale": fp32
    (nblocks, 1)}``."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax == 0, 1.0,
                        _div127(absmax) if signed else _div255(absmax))
    q = torch.round(blocks / scale)
    if signed:
        q = torch.clamp(q, -127, 127).to(torch.int8)
    else:
        q = torch.clamp(q, 0, 255).to(torch.uint8)
    return {"q": q, "scale": scale}


def dequantize_blockwise(qs: Dict[str, torch.Tensor],
                         shape: Sequence[int]) -> torch.Tensor:
    """``{"q", "scale"}`` -> the fp32 tensor of ``shape`` (the padding
    dropped)."""
    flat = (qs["q"].float() * qs["scale"]).reshape(-1)
    size = torch.Size(shape).numel()
    return flat[:size].reshape(tuple(shape))

