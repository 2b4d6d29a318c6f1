"""Training losses (counterpart of kosmosx_tpu/train/loss.py).

Next-token cross-entropy over logits, masked for padding, in fp32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *,
                    z_loss: float = 0.0
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM loss: predict ``labels[:, t+1]`` from ``logits[:, t]``
    (kosmosx_tpu/train/loss.py:18-47).

    logits (B, L, V); labels (B, L) int; mask (B, L), 1 for real tokens at
    the label position. Returns (scalar loss, metrics ``loss``,
    ``cross_entropy``, ``accuracy``, ``tokens``, ``perplexity``). ``z_loss``
    adds the PaLM log-normaliser term."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:].long()
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=logits.device)
    else:
        mask = mask[:, 1:].float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.take_along_dim(logits, targets[..., None], dim=-1)[..., 0]
    nll = logz - true_logit
    denom = mask.sum().clamp_min(1.0)
    ce = (nll * mask).sum() / denom
    loss = ce
    if z_loss > 0.0:
        loss = loss + z_loss * (logz.square() * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(-1) == targets) * mask).sum() / denom
        metrics = {"loss": loss.detach(), "cross_entropy": ce.detach(),
                   "accuracy": acc, "tokens": mask.sum(),
                   "perplexity": torch.exp(ce.detach())}
    return loss, metrics


def multimodal_next_token_loss(logits: torch.Tensor, text_tokens: torch.Tensor,
                               image_embed_len: int, splice_index: int = 2,
                               pad_id: int = 1, *, z_loss: float = 0.0):
    """Loss over a Kosmos spliced sequence with one image block
    (kosmosx_tpu/train/loss.py:50-67): logits cover ``[tok_0 .. tok_{s-1},
    k image positions, tok_s ..]`` and only text tokens are targets. The
    label tok_s is predicted by the last image slot, while the ``<image>``
    token at s-1 predicts an image embedding and is not supervised, so
    ``logits[s-1 : s+k-1]`` are dropped."""
    k, s = image_embed_len, splice_index
    text_logits = torch.cat([logits[:, :s - 1], logits[:, s + k - 1:]], dim=1)
    mask = text_tokens != pad_id
    return next_token_loss(text_logits, text_tokens, mask, z_loss=z_loss)
