"""Draft-model distillation for speculative decoding (counterpart of
kosmosx_tpu/train/distill.py).

Speculative decoding gains only when the draft proposes what the target
would: its acceptance rate needs a draft that mimics the target's
next-token distribution. ``distill_draft`` trains one with the forward KL
from the frozen target's logits to the draft's. The teacher runs under
``no_grad``, so no teacher activation is kept for a backward.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

from kosmosx_torch.core.params import tree_device
from kosmosx_torch.nn import decoder as dec
from kosmosx_torch.train.optim import Optimizer


def distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 temperature: float = 1.0) -> Tuple[torch.Tensor, Dict]:
    """Forward KL(teacher || student) per token, the mean over ``mask``
    (B, L) (kosmosx_tpu/train/distill.py:28-47): logits (B, L, V) softened
    at ``temperature`` T, the loss scaled by T^2 so that its gradients
    match the T = 1 limit; ``teacher_agreement`` is the masked share of
    positions where both argmaxes agree."""
    t = max(temperature, 1e-6)
    sp = F.log_softmax(student_logits.float() / t, dim=-1)
    tp = F.log_softmax(teacher_logits.float() / t, dim=-1)
    kl = (tp.exp() * (tp - sp)).sum(-1)
    mask = torch.ones_like(kl) if mask is None else mask.float()
    denom = mask.sum().clamp_min(1.0)
    loss = (kl * mask).sum() / denom * (t * t)
    with torch.no_grad():
        agree = ((sp.argmax(-1) == tp.argmax(-1)) * mask).sum() / denom
    return loss, {"distill_loss": loss.detach(), "teacher_agreement": agree}


def make_distill_step(cfg_student, cfg_teacher, optimizer, *,
                      temperature: float = 1.0) -> Callable:
    """``step(state, teacher_params, tokens, mask) -> (state, metrics)``
    (kosmosx_tpu/train/distill.py:50-72), ``state = {"params": student
    module, "opt_state": optimizer}``: the teacher's logits under
    ``no_grad``, the student's gradients, ``optimizer`` (over the
    student's parameters) applied in place."""

    def step(state, teacher_params, tokens, mask):
        student = state["params"]
        with torch.no_grad():
            teacher_logits = dec.decoder_forward(teacher_params, tokens,
                                                 cfg_teacher)
        student.set_trainable()
        names, params = zip(*student.named_parameters())
        loss, metrics = distill_loss(
            dec.decoder_forward(student, tokens, cfg_student),
            teacher_logits, mask, temperature)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        optimizer.step(dict(zip(names, grads)))
        return state, metrics

    return step


def distill_draft(teacher_params, cfg_teacher, cfg_draft,
                  batches: Iterable[Dict], *, steps: int = 200,
                  learning_rate: float = 1e-3, temperature: float = 1.0,
                  seed: int = 0, log_every: int = 0) -> Tuple[object, Dict]:
    """Train a fresh draft (``KosmosLanguage`` of ``cfg_draft`` from a
    generator seeded with ``seed``, on the teacher's device) to mimic
    ``teacher_params`` over ``batches`` of ``{"input_ids"[,
    "attention_mask"]}`` (kosmosx_tpu/train/distill.py:75-105). The
    optimizer is JAX's ``optax.adamw(learning_rate, weight_decay=0.0)``:
    betas 0.9 and 0.999, eps 1e-8, a constant rate, no clipping. Returns
    (draft, final metrics as floats)."""
    from kosmosx_torch.models.language import KosmosLanguage

    device = tree_device(teacher_params)
    draft = KosmosLanguage(
        cfg_draft, generator=torch.Generator(device=device).manual_seed(seed),
        device=device)
    opt = Optimizer(dict(draft.named_parameters()), "adamw",
                    lambda count: learning_rate, weight_decay=0.0,
                    beta1=0.9, beta2=0.999, grad_clip=None)
    state = {"params": draft, "opt_state": opt}
    step = make_distill_step(cfg_draft, cfg_teacher, opt,
                             temperature=temperature)
    metrics: Dict = {}
    for i, batch in enumerate(batches):
        if i >= steps:
            break
        tokens = torch.as_tensor(batch["input_ids"], device=device).long()
        mask = batch.get("attention_mask")
        mask = torch.ones(tokens.shape, device=device) if mask is None else \
            torch.as_tensor(mask, device=device).float()
        state, metrics = step(state, teacher_params, tokens, mask)
        if log_every and (i + 1) % log_every == 0:
            print(f"distill step {i + 1}: "
                  f"{ {k: float(v) for k, v in metrics.items()} }")
    return state["params"], {k: float(v) for k, v in metrics.items()}
