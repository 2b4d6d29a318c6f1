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

A leaf sharded over ranks (FSDP, ``parallel/sharding.LocalShard``) keeps
the blocks of the WHOLE leaf: a rank's run of elements starts ``offset %
256`` into a block, so its local blocks are padded on the left by that
much, and the absmax of a block two ranks share is all-reduced (MAX) over
the shard group. Each element's code is then the one the whole leaf's
quantization gives it, and the ranks' codes put end to end are the JAX
package's. A leaf cut over ``tensor`` or ``expert`` (``LocalShard.cuts``)
is not a run of the flattened leaf: its codes are kept one per local
element, beside the scales of ALL the whole leaf's blocks (each
element's block is its position in the whole leaf over 256; the absmax
of every block is all-reduced, MAX, over the shard's groups).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from kosmosx_torch.utils.quantize import _div127, _div255

BLOCK = 256


def lead(shard, n: int, block: int = BLOCK) -> int:
    """How far into its first block a shard's run of ``n`` elements starts
    (0 for no shard or an empty run)."""
    return 0 if shard is None or n == 0 else shard.offset % block


def _global_absmax(absmax: torch.Tensor, shard, block: int) -> torch.Tensor:
    """The local blocks' absmax, all-reduced (MAX) with the other ranks'
    over the whole leaf's blocks."""
    from kosmosx_torch.parallel.comm import all_reduce

    total = -(-shard.numel // block)
    first = shard.offset // block
    vec = absmax.new_zeros(total)
    vec[first:first + absmax.shape[0]] = absmax[:, 0]
    vec = all_reduce([vec], shard.group, op=torch.distributed.ReduceOp.MAX)[0]
    return vec[first:first + absmax.shape[0], None]


def quantize_blockwise(x: torch.Tensor, *, signed: bool = True,
                       block: int = BLOCK, shard=None) -> Dict[str, torch.Tensor]:
    """A tensor -> ``{"q": int8 or uint8 (nblocks, block), "scale": fp32
    (nblocks, 1)}``; ``shard``: where ``x`` lies in a leaf sharded over
    ranks (its blocks then are the leaf's, the first padded on the left by
    ``lead(shard)``; for a cut leaf, ``{"q": (n,) codes, "scale": the
    whole leaf's (nblocks, 1)}``)."""
    flat = x.float().reshape(-1)
    n = flat.numel()
    if shard is not None and shard.cuts:
        return _quantize_cut(flat, shard, signed, block)
    left = lead(shard, n, block)
    nblocks = -(-(left + n) // block) if n else 0
    flat = F.pad(flat, (left, nblocks * block - left - n))
    blocks = flat.reshape(nblocks, block)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    if shard is not None:
        absmax = _global_absmax(absmax, shard, block)
    scale = torch.where(absmax == 0, 1.0,
                        _div127(absmax) if signed else _div255(absmax))
    q = torch.round(blocks / scale)
    if signed:
        q = torch.clamp(q, -127, 127).to(torch.int8)
    else:
        q = torch.clamp(q, 0, 255).to(torch.uint8)
    return {"q": q, "scale": scale}


def _quantize_cut(flat, shard, signed: bool, block: int):
    """``quantize_blockwise`` of a cut leaf's local elements ``flat``."""
    from kosmosx_torch.parallel.comm import all_reduce

    blocks = shard.flat_index(flat.numel(), flat.device) // block
    total = -(-shard.numel // block)
    absmax = flat.new_zeros(total).scatter_reduce(0, blocks, flat.abs(),
                                                  "amax")
    absmax = all_reduce([absmax], shard.group,
                        op=torch.distributed.ReduceOp.MAX)[0][:, None]
    scale = torch.where(absmax == 0, 1.0,
                        _div127(absmax) if signed else _div255(absmax))
    q = torch.round(flat / scale[blocks, 0])
    if signed:
        q = torch.clamp(q, -127, 127).to(torch.int8)
    else:
        q = torch.clamp(q, 0, 255).to(torch.uint8)
    return {"q": q, "scale": scale}


def dequantize_blockwise(qs: Dict[str, torch.Tensor],
                         shape: Sequence[int], shard=None) -> torch.Tensor:
    """``{"q", "scale"}`` -> the fp32 tensor of ``shape`` (the padding
    dropped; for a shard, the ``lead(shard)`` elements before it too)."""
    if shard is not None and shard.cuts:
        size = torch.Size(shape).numel()
        blocks = shard.flat_index(size, qs["q"].device) // BLOCK
        return (qs["q"].float() * qs["scale"][blocks, 0]).reshape(
            tuple(shape))
    flat = (qs["q"].float() * qs["scale"]).reshape(-1)
    size = torch.Size(shape).numel()
    left = lead(shard, size)
    return flat[left:left + size].reshape(tuple(shape))

