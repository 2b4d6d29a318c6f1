"""KosmosLanguage, the text-only Magneto decoder LM
(counterpart of kosmosx_tpu/models/language.py)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from kosmosx_torch.core.config import MagnetoConfig
from kosmosx_torch.core.initializers import model_device
from kosmosx_torch.core.params import ParamTree
from kosmosx_torch.nn import decoder as dec


class KosmosLanguage(ParamTree):
    """Decoder LM whose parameters are the decoder tree
    (``embed``, ``pos``, ``layers.i...``, ``ln``, ``out_proj``).

    Build it from a seeded ``torch.Generator`` (random init on ``device``,
    the card unless ``device="cpu"`` is asked for; the generator must lie on
    that device) or from a parameter tree such as the result of
    ``utils.jax_params.from_jax_params``."""

    def __init__(self, config: Optional[MagnetoConfig] = None, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 params: Optional[Dict[str, Any]] = None):
        config = config or MagnetoConfig()
        if params is None:
            if generator is None:
                raise ValueError("pass a seeded torch.Generator or params")
            params = dec.init_decoder(
                generator, config, device=model_device(generator, device))
        super().__init__(params)
        self.config = config

    def apply(self, tokens: torch.Tensor, *,
              segment_ids: Optional[torch.Tensor] = None,
              rng: Optional[int] = None, with_aux: bool = False):
        """tokens (B, L) -> logits (B, L, vocab), or (logits, aux) with
        ``with_aux``, aux the summed MoE routing loss (0 for a dense
        decoder) (kosmosx_tpu/models/language.py:73-79); ``rng`` is the
        dropout key."""
        return dec.decoder_forward(self, tokens, self.config,
                                   segment_ids=segment_ids, rng=rng,
                                   with_aux=with_aux)

    forward = apply
