"""Seeded weights and seeded inputs, made on the device.

Weights are drawn chunk by chunk: the leaves of one chunk (the vision
tower, the resampler and projection, the decoder's tables and head, each
block of six decoder layers) take their values from one large uniform
and one large normal draw of a generator seeded from ``(seed, chunk)``.
So a run makes them in a few calls, and any chunk can be drawn again
alone: the same seed gives the same tensors, to the program and to the
reference.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Tuple

import torch

from perfbench.reference.kosmos import padding_rows, param_specs

LAYERS_PER_CHUNK = 6


def mix(seed: int, *tags) -> int:
    """A 63-bit generator seed from a run's seed and tags."""
    data = ":".join(str(x) for x in (seed,) + tags).encode()
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *tags))


def chunk_of(path: str) -> str:
    parts = path.split(".")
    if parts[0] == "decoder" and parts[1] == "layers":
        return f"decoder.layers.{int(parts[2]) // LAYERS_PER_CHUNK}"
    if parts[0] == "decoder":
        return "decoder"
    if parts[0] in ("resampler", "image_proj"):
        return "resampler"
    return parts[0]


def chunks(cfg: dict) -> Dict[str, List[tuple]]:
    """The parameter specs grouped by chunk, in spec order."""
    out: Dict[str, List[tuple]] = {}
    for spec in param_specs(cfg):
        out.setdefault(chunk_of(spec[0]), []).append(spec)
    return out


def make_chunk(cfg: dict, seed: int, name: str, specs: List[tuple], device,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """One chunk's leaves, each a tensor of its own in ``dtype``."""
    n_u = sum(torch.Size(s).numel() for _, s, k, _ in specs if k == "uniform")
    n_n = sum(torch.Size(s).numel() for _, s, k, _ in specs if k == "normal")
    gen = generator(device, seed, "weights", name)
    uni = torch.rand(n_u, generator=gen, device=device)
    nor = torch.randn(n_n, generator=gen, device=device)
    pads = padding_rows(cfg)
    out, iu, in_ = {}, 0, 0
    for path, shape, kind, arg in specs:
        n = torch.Size(shape).numel()
        if kind == "uniform":
            t = uni[iu:iu + n].view(shape).mul(2.0 * arg).sub_(arg)
            iu += n
        elif kind == "normal":
            t = nor[in_:in_ + n].view(shape).mul(arg)
            in_ += n
        elif kind == "zeros":
            t = torch.zeros(shape, device=device)
        else:
            t = torch.ones(shape, device=device)
        if path in pads:
            t[pads[path]] = 0.0
        out[path] = t.to(dtype)
    return out


def iter_chunks(cfg: dict, seed: int, device, dtype
                ) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    for name, specs in chunks(cfg).items():
        yield name, make_chunk(cfg, seed, name, specs, device, dtype)


def make_weights(cfg: dict, seed: int, device,
                 dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Every parameter, ``{dotted path: tensor}``, in ``dtype``."""
    out: Dict[str, torch.Tensor] = {}
    for _, part in iter_chunks(cfg, seed, device, dtype):
        out.update(part)
    return out


def pixels(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """CLIP-normalised uniform random images, (n, 3, size, size) float32."""
    mean = torch.tensor((0.48145466, 0.4578275, 0.40821073), device=device)
    std = torch.tensor((0.26862954, 0.26130258, 0.27577711), device=device)
    raw = torch.rand(n, 3, size, size, generator=gen, device=device)
    return (raw - mean[:, None, None]) / std[:, None, None]


def tokens(gen: torch.Generator, shape, vocab: int, device) -> torch.Tensor:
    """Uniform token ids in [4, vocab) with BOS (0) first: no padding id,
    so every position is a real token."""
    t = torch.randint(4, vocab, shape, generator=gen, device=device)
    t[..., 0] = 0
    return t
