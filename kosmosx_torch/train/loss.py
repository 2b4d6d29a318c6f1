"""Training losses (counterpart of kosmosx_tpu/train/loss.py).

Next-token cross-entropy over logits, masked for padding, in fp32.

Under data parallelism (``Trainer`` over a mesh) a rank holds some rows of
the global batch. Inside ``global_batch(group)`` the losses return this
rank's SHARE of the global batch's loss: its sum over the global count
(the denominators all-reduced over ``group``), so that the SUM of the
ranks' gradients is the gradient of the global loss, as JAX's GSPMD step
computes it over the global array; their metrics are the global ones, the
same on every rank. Outside, nothing changes.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

_GROUP = None


@contextlib.contextmanager
def global_batch(group):
    """Within, losses are this rank's share of the loss of the global
    batch split over ``group``'s ranks (None: one rank holds it all)."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def _psum(*ts: torch.Tensor):
    """The detached tensors summed over the global batch's ranks."""
    ts = [t.detach() for t in ts]
    if _GROUP is None:
        return ts
    from kosmosx_torch.parallel.comm import all_reduce

    return all_reduce(ts, _GROUP)


def share_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` over the global batch, this rank's share: ``x.mean()``
    alone, else ``x.sum()`` over the global element count."""
    if _GROUP is None:
        return x.mean()
    n = _psum(torch.tensor(float(x.numel()), device=x.device))[0]
    return x.sum() / n


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The detached sum of the ranks' ``x`` (of their loss shares: the
    global loss)."""
    return _psum(x)[0]


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The detached mean of ``x`` over the global batch."""
    return _psum(share_mean(x))[0]


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
    tokens = _psum(mask.sum())[0]
    denom = tokens.clamp_min(1.0)
    ce = (nll * mask).sum() / denom
    loss = ce
    if z_loss > 0.0:
        loss = loss + z_loss * (logz.square() * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(-1) == targets) * mask).sum() / denom
        loss_g, ce_g, acc = _psum(loss, ce, acc)
        metrics = {"loss": loss_g, "cross_entropy": ce_g,
                   "accuracy": acc, "tokens": tokens,
                   "perplexity": torch.exp(ce_g)}
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
