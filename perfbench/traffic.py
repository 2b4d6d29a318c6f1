"""The general traffic generator: requests from a mix's parameters.

A mix file (``perfbench/traffic/<mix>.json``) gives, for a serving driver:

- ``shape_seed``: the seed of the sizes, so every run serves the same
  multiset of request sizes and only their order follows the run's seed;
- ``requests``: how many request sizes to draw (more than a run serves);
- ``prompt``: ``{"dist": "lognormal", "median", "sigma", "min", "max"}``
  or ``{"dist": "uniform", "min", "max"}`` text tokens;
- ``image_share``: the share of requests that carry one image;
- ``new_tokens``: ``{"min", "max"}``, uniform, the tokens to generate.

Token ids are drawn on the host and images on the device, both from the
run's seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from perfbench import weights


@dataclasses.dataclass
class Shape:
    prompt_len: int
    image: bool
    new_tokens: int


def _lengths(spec: dict, n: int, rng: np.random.RandomState) -> np.ndarray:
    if spec["dist"] == "lognormal":
        x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    elif spec["dist"] == "uniform":
        x = rng.uniform(spec["min"], spec["max"] + 1, n)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.floor(x), spec["min"], spec["max"]).astype(np.int64)


def shapes(mix: dict) -> List[Shape]:
    """The mix's request sizes, the same for every run."""
    rng = np.random.RandomState(mix["shape_seed"])
    n = mix["requests"]
    prompts = _lengths(mix["prompt"], n, rng)
    images = np.zeros(n, bool)
    images[:int(round(n * mix["image_share"]))] = True
    rng.shuffle(images)
    new = rng.randint(mix["new_tokens"]["min"], mix["new_tokens"]["max"] + 1,
                      n)
    return [Shape(int(p), bool(i), int(t))
            for p, i, t in zip(prompts, images, new)]


@dataclasses.dataclass
class Request:
    prompt: List[int]
    images: Optional[torch.Tensor]
    new_tokens: int


class Stream:
    """A run's requests: the mix's sizes in an order drawn from the seed,
    each with its own tokens and image."""

    def __init__(self, mix: dict, cfg: dict, seed: int, device):
        self.shapes = shapes(mix)
        order = np.random.RandomState(weights.mix(seed, "order") % 2 ** 32)
        self.order = order.permutation(len(self.shapes))
        self.rng = np.random.RandomState(weights.mix(seed, "tokens") % 2 ** 32)
        self.gen = weights.generator(device, seed, "images")
        self.vocab = cfg["decoder"]["vocab_size"]
        self.size = cfg["vision"]["image_size"]
        self.device = device
        self.i = 0

    def next(self) -> Request:
        if self.i >= len(self.order):
            raise RuntimeError("the mix's requests are used up; raise "
                               "'requests'")
        s = self.shapes[self.order[self.i]]
        self.i += 1
        toks = self.rng.randint(4, self.vocab, s.prompt_len)
        toks[0] = 0
        img = weights.pixels(self.gen, 1, self.size, self.device) \
            if s.image else None
        return Request(toks.tolist(), img, s.new_tokens)
