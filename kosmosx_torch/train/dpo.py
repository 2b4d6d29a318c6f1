"""Direct Preference Optimization (counterpart of kosmosx_tpu/train/dpo.py).

The frozen reference's sequence log-probs are computed once per batch,
outside the training step (``compute_ref_logprobs``), so the loss keeps the
``loss_fn(model, batch, rng)`` contract of ``Trainer`` and composes with
remat, LoRA (adapt the policy only) and the 8-bit optimizers. The
optimizers update parameters in place: a reference that shares tensors
with the policy would follow it step by step. Under LoRA the reference is
the frozen base; without, an independent copy of the starting parameters.

Loss (Rafailov et al. 2023): ``-log sigma(beta * ((pi_c - pi_r) - (ref_c -
ref_r)))``; ``reference_free=True`` drops the reference term.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from kosmosx_torch.core.params import tree_device
from kosmosx_torch.nn import decoder as dec
from kosmosx_torch.nn import layers
from kosmosx_torch.train.loss import global_mean, global_sum, share_mean


def sequence_logprob(params, cfg, tokens: torch.Tensor, weights: torch.Tensor,
                     rng: Optional[int] = None) -> torch.Tensor:
    """Sum of per-token log-probs over weighted positions
    (kosmosx_tpu/train/dpo.py:29-51): tokens (B, L), weights (B, L) 1.0 on
    completion tokens (the labels whose log-prob counts), 0.0 on prompt
    and padding; ``weights[t]`` gates label ``tokens[t]``, predicted from
    position t - 1. ``log p = true_logit - logsumexp``: no (B, L, V) fp32
    log-softmax besides the logits' fp32 copy. -> (B,)."""
    logits = dec.decoder_forward(params, tokens.long(), cfg, rng=rng)
    pred = logits[:, :-1]
    labels = tokens[:, 1:].long()
    w = weights[:, 1:].float()
    logz = torch.logsumexp(pred.float(), dim=-1)
    true_logit = torch.take_along_dim(pred, labels[..., None],
                                      dim=-1)[..., 0].float()
    return ((true_logit - logz) * w).sum(-1)


def compute_ref_logprobs(ref_params, cfg, batch: Dict) -> Dict:
    """``batch`` with the frozen reference's sequence log-probs added as
    ``ref_chosen_logp`` and ``ref_rejected_logp`` on its device, under
    ``no_grad`` (kosmosx_tpu/train/dpo.py:63-73). Run it outside the
    training step; the reference never enters the optimizer."""
    device = tree_device(ref_params)
    out = dict(batch)
    with torch.no_grad():
        for side in ("chosen", "rejected"):
            out[f"ref_{side}_logp"] = sequence_logprob(
                ref_params, cfg, torch.as_tensor(batch[side], device=device),
                torch.as_tensor(batch[f"{side}_weights"], device=device))
    return out


def dpo_loss_fn(model_cfg, *, beta: float = 0.1,
                reference_free: bool = False) -> Callable:
    """A ``Trainer`` loss over preference batches ``{"chosen",
    "chosen_weights", "rejected", "rejected_weights"[, "ref_chosen_logp",
    "ref_rejected_logp"]}`` with the metrics ``loss``, ``reward_margin``,
    ``reward_accuracy``, ``chosen_logp`` and ``rejected_logp``
    (kosmosx_tpu/train/dpo.py:76-104). The dropout key splits in two, one
    for each side."""

    def loss_fn(model, batch, rng):
        pi_c = sequence_logprob(model, model_cfg, batch["chosen"],
                                batch["chosen_weights"],
                                rng=layers.fold_in(rng, 0))
        pi_r = sequence_logprob(model, model_cfg, batch["rejected"],
                                batch["rejected_weights"],
                                rng=layers.fold_in(rng, 1))
        logits_diff = pi_c - pi_r
        if not reference_free:
            logits_diff = logits_diff - (batch["ref_chosen_logp"]
                                         - batch["ref_rejected_logp"])
        # over a mesh, this rank's share of the global mean (train/loss.py)
        loss = share_mean(-F.logsigmoid(beta * logits_diff))
        with torch.no_grad():
            metrics = {
                "loss": global_sum(loss),
                "reward_margin": global_mean(beta * logits_diff),
                "reward_accuracy": global_mean((logits_diff > 0).float()),
                "chosen_logp": global_mean(pi_c),
                "rejected_logp": global_mean(pi_r),
            }
        return loss, metrics

    return loss_fn


def preference_batch(prompt, chosen, rejected, *, pad_id: int = 1,
                     length: Optional[int] = None) -> Dict[str, np.ndarray]:
    """One host-side preference batch from token-id lists
    (kosmosx_tpu/train/dpo.py:107-144): each row is ``prompt +
    completion`` padded with ``pad_id`` to ``length`` (default the longest
    row), int32 tokens and float32 weights 1.0 on the completion only. A
    row longer than ``length`` raises: a cut completion would train on a
    zero-weight pair."""

    def pack(completions):
        rows, ws = [], []
        for p, c in zip(prompt, completions):
            rows.append(list(p) + list(c))
            ws.append([0.0] * len(p) + [1.0] * len(c))
        ln = length or max(len(r) for r in rows)
        toks = np.full((len(rows), ln), pad_id, np.int32)
        wgt = np.zeros((len(rows), ln), np.float32)
        for i, (r, w) in enumerate(zip(rows, ws)):
            if len(r) > ln:
                raise ValueError(
                    f"row {i}: prompt+completion length {len(r)} exceeds "
                    f"length={ln}; raise `length`")
            toks[i, :len(r)] = r
            wgt[i, :len(r)] = w
        return toks, wgt

    ct, cw = pack(chosen)
    rt, rw = pack(rejected)
    return {"chosen": ct, "chosen_weights": cw,
            "rejected": rt, "rejected_weights": rw}
