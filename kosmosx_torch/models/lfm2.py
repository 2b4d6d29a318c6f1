"""Lfm2, the LFM2 hybrid MoE language model (``lfm2_moe``; LiquidAI's
LFM2-24B-A2B at the defaults of ``core.config.Lfm2Config``).

The JAX package has no counterpart. The port runs its forward pass, the
path offline scoring takes: ``apply(tokens)`` under ``inference_mode``.
Training and generation are not ported (generation needs a cache holding
two kinds of state side by side, the conv layers' last positions and the
attention layers' keys and values), and raise ``NotImplementedError``
rather than take another model's path.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from kosmosx_torch.core.config import Lfm2Config
from kosmosx_torch.core.initializers import model_device
from kosmosx_torch.core.params import ParamTree
from kosmosx_torch.nn import lfm2

_FORWARD_ONLY = ("Lfm2 runs the forward pass only: {what} is not ported "
                 "(see ROADMAP.md, Queue 6)")


class Lfm2(ParamTree):
    """The model whose parameters are ``nn/lfm2.py``'s tree (``embed``,
    ``layers.i...``, ``norm``).

    Build it from a seeded ``torch.Generator`` (random init on ``device``,
    the card unless ``device="cpu"`` is asked for; the generator must lie on
    that device) or from a parameter tree ``params`` (nested dicts of
    tensors, such as the benchmark's weights)."""

    def __init__(self, config: Optional[Lfm2Config] = None, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 params: Optional[Dict[str, Any]] = None):
        config = config or Lfm2Config()
        config.check_supported()
        if params is None:
            if generator is None:
                raise ValueError("pass a seeded torch.Generator or params")
            params = lfm2.init_lfm2(generator, config,
                                    device=model_device(generator, device))
        super().__init__(params)
        self.config = config

    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L), one sequence a row, every position a real token
        -> logits (B, L, vocab) in the compute dtype. Raises where a
        gradient would be taken."""
        if torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            raise NotImplementedError(_FORWARD_ONLY.format(what="training"))
        return lfm2.forward(self, tokens, self.config)

    forward = apply

    def set_trainable(self, freeze=()) -> None:
        raise NotImplementedError(_FORWARD_ONLY.format(what="training"))

    def generate(self, *args, **kwargs):
        raise NotImplementedError(_FORWARD_ONLY.format(
            what="generation (a conv-state and KV cache)"))
