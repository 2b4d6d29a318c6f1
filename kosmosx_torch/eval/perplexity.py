"""Perplexity over packed token batches (counterpart of
kosmosx_tpu/eval/perplexity.py).

Token-weighted across batches: the summed NLL and the token count are
accumulated and exponentiated once at the end, not averaged per batch. The
forward runs in the model's compute dtype; the NLL is reduced in fp32
(``next_token_loss`` casts the logits up before the logsumexp).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from kosmosx_torch.nn.decoder import decoder_forward
from kosmosx_torch.train.loss import next_token_loss


def make_eval_step(cfg) -> Callable:
    """``step(params, input_ids, mask) -> (nll_sum, n_tokens)``, 0-d fp32
    tensors on the parameters' device, without gradients or dropout.
    Right padding is assumed (packed blocks are full; ragged rows pad at
    the end, which causal attention keeps out of every real query)."""

    @torch.no_grad()
    def step(params, input_ids, mask):
        logits = decoder_forward(params, input_ids, cfg)
        _, metrics = next_token_loss(logits, input_ids, mask)
        return metrics["cross_entropy"] * metrics["tokens"], metrics["tokens"]

    return step


def evaluate_perplexity(params, batches: Iterable[Dict[str, np.ndarray]],
                        cfg, *, max_batches: Optional[int] = None,
                        device=None) -> Dict[str, float]:
    """Token-weighted perplexity of a decoder (a ``KosmosLanguage`` or its
    parameter tree) over ``{"input_ids", "attention_mask"}`` batches (as
    ``train.data.packed_text_batches`` yields them), on ``device`` (default:
    the parameters'). Returns ``{perplexity, cross_entropy, tokens,
    batches}``."""
    if device is None:
        device = next(iter(params.parameters())).device
    step = make_eval_step(cfg)
    nll_sum = torch.zeros((), dtype=torch.float64, device=device)
    tok_sum = torch.zeros((), dtype=torch.float64, device=device)
    n = 0
    for batch in batches:
        if max_batches is not None and n >= max_batches:
            break
        ids = torch.as_tensor(batch["input_ids"]).to(device)
        mask = torch.as_tensor(batch.get(
            "attention_mask", np.ones(ids.shape, np.int32))).to(device)
        nll, toks = step(params, ids, mask)
        nll_sum += nll
        tok_sum += toks
        n += 1
    nll_total, tok_total = float(nll_sum), float(tok_sum)
    ce = nll_total / max(tok_total, 1.0)
    return {"perplexity": float(math.exp(ce)), "cross_entropy": ce,
            "tokens": tok_total, "batches": n}
