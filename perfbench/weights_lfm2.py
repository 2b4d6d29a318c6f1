"""Seeded weights and seeded token ids of the LFM2 configuration
(``perfbench/configs/lfm2-24b-a2b.json``), made on the device.

Weights: each chunk (the embedding table and final norm; each layer) takes
its leaves from a generator seeded from ``(seed, chunk)``
(``perfbench.weights.mix``), one leaf after another in the order of
``perfbench.reference.lfm2.param_specs``, drawn in float32 and stored in
bfloat16, the expert bias in float32. The same seed gives the same
tensors, to the program and to the reference.

Token ids: Zipf's law with exponent ``s`` over the vocabulary (id ``i``
drawn with probability proportional to ``(i + 1) ** -s``), as a
tokenizer's ids fall in text, so that a few ids recur often and the
router's load is uneven, as it is on real text.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

from perfbench.reference.lfm2 import param_specs
from perfbench.weights import generator

FP32_LEAVES = ("expert_bias",)


def chunk_of(path: str) -> str:
    parts = path.split(".")
    return f"layers.{parts[1]}" if parts[0] == "layers" else "outer"


def chunks(cfg: dict) -> Dict[str, List[tuple]]:
    """The parameter specs grouped by chunk, in spec order."""
    out: Dict[str, List[tuple]] = {}
    for spec in param_specs(cfg):
        out.setdefault(chunk_of(spec[0]), []).append(spec)
    return out


def make_chunk(seed: int, name: str, specs: List[tuple], device,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    gen = generator(device, seed, "lfm2-weights", name)
    out = {}
    for path, shape, kind, arg in specs:
        if kind == "normal":
            t = torch.randn(shape, generator=gen, device=device).mul_(arg[0])
        else:
            lo, hi = arg
            t = torch.rand(shape, generator=gen, device=device)
            t = t.mul_(hi - lo).add_(lo)
        keep = torch.float32 if path.rsplit(".", 1)[-1] in FP32_LEAVES \
            else dtype
        out[path] = t.to(keep)
        del t
    return out


def iter_chunks(cfg: dict, seed: int, device, dtype
                ) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    for name, specs in chunks(cfg).items():
        yield name, make_chunk(seed, name, specs, device, dtype)


def make_weights(cfg: dict, seed: int, device,
                 dtype: torch.dtype = torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """Every parameter, ``{dotted path: tensor}``, in ``dtype`` (the expert
    bias in float32)."""
    out: Dict[str, torch.Tensor] = {}
    for _, part in iter_chunks(cfg, seed, device, dtype):
        out.update(part)
    return out


def zipf_cdf(vocab: int, s: float, device) -> torch.Tensor:
    """The cumulative distribution (vocab,) float64 of Zipf's law with
    exponent ``s`` over ``vocab`` ids."""
    ranks = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    cdf = ranks.pow(-s).cumsum(0)
    return cdf / cdf[-1]


def zipf_tokens(gen: torch.Generator, cdf: torch.Tensor, shape
                ) -> torch.Tensor:
    """Token ids of ``shape`` drawn from the distribution ``cdf``
    (``zipf_cdf``) by inverting it at uniform draws, int64 on its device:
    no read of the device from the host."""
    u = torch.rand(shape, generator=gen, device=cdf.device,
                   dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)
