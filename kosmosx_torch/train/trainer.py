"""Training on one device (counterpart of kosmosx_tpu/train/trainer.py).

The JAX package jits one SPMD train step over a mesh; here the step is eager
PyTorch on one device: the loss and its gradients with autograd (the flash
attention kernels' backward included), the pre-clip global norm, and the
optimizer chain applied in place. A parameter tree's top-level subtrees
named in ``TrainConfig.freeze`` take no gradient and no optimizer state, so
autograd saves no activations for their backward.

Out-of-slice settings raise ``NotImplementedError`` naming their ROADMAP
item: the 8-bit optimizers, ``grad_accum > 1``, a mesh of more than one
device, ``per_process_batches`` and dropout with an rng.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from kosmosx_torch.core.config import not_ported
from kosmosx_torch.train import checkpoint as ckpt
from kosmosx_torch.train.data import device_prefetch, to_device
from kosmosx_torch.train.loss import multimodal_next_token_loss, next_token_loss
from kosmosx_torch.train.optim import Optimizer, make_optimizer, make_schedule

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors kosmosx_tpu/train/trainer.py:39-92: same fields, same
    defaults (field comments there). ``per_process_batches``, a mesh other
    than one device (``data`` -1 or 1, ``fsdp``, ``tensor`` and ``expert``
    1), ``grad_accum > 1`` and the 8-bit optimizers raise."""

    batch_size: int = 1
    grad_accum: int = 1
    seq_len: int = 8192
    seed: int = 42
    learning_rate: float = 1e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    optimizer: str = "lion"
    schedule: str = "cosine"
    total_steps: int = 100_000
    warmup_steps: Optional[int] = None
    z_loss: float = 0.0
    checkpoint_every: int = 1000
    log_every: int = 100
    eval_every: int = 0
    per_process_batches: bool = False
    prefetch: bool = True
    output_dir: str = "checkpoints/"
    resume: bool = False
    final_save: bool = False
    freeze: tuple = ()
    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    expert: int = 1

    def check_supported(self) -> None:
        if self.optimizer in ("adamw8bit", "lion8bit"):
            raise not_ported(f"the 8-bit optimizer {self.optimizer!r} "
                             "(train/quant.py)", "Queue 1 item 6")
        if self.grad_accum > 1:
            raise not_ported("gradient accumulation (grad_accum > 1, "
                             "optax.MultiSteps)", "Queue 1 item 6")
        if self.data not in (-1, 1) or (self.fsdp, self.tensor,
                                        self.expert) != (1, 1, 1):
            raise not_ported(
                f"a mesh other than one device (data={self.data}, "
                f"fsdp={self.fsdp}, tensor={self.tensor}, "
                f"expert={self.expert})", "Queue 1 item 10")
        if self.per_process_batches:
            raise not_ported("per_process_batches (multi-process data)",
                             "Queue 1 item 10")


def split_frozen(params, freeze) -> Tuple[Dict[str, torch.Tensor],
                                          Dict[str, torch.Tensor]]:
    """(trainable, frozen) named parameters of a parameter tree, split by
    top-level key (kosmosx_tpu/train/trainer.py:105-111)."""
    trainable, frozen = {}, {}
    for name, p in params.named_parameters():
        (frozen if name.split(".", 1)[0] in freeze else trainable)[name] = p
    return trainable, frozen


def value_and_grad(loss_fn: Callable, model, batch, rng=None,
                   freeze: tuple = ()):
    """``((loss, metrics), grads)`` of ``loss_fn(model, batch, rng)`` with
    respect to the trainable parameters (name -> gradient, ``None`` for a
    parameter the loss does not reach). Frozen subtrees get
    ``requires_grad=False``, so their forward records nothing."""
    model.set_trainable(freeze)
    trainable, _ = split_frozen(model, freeze)
    loss, metrics = loss_fn(model, batch, rng)
    grads = torch.autograd.grad(loss, list(trainable.values()),
                                allow_unused=True)
    return (loss.detach(), metrics), dict(zip(trainable, grads))


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    freeze: tuple = ()) -> Callable:
    """``step(model, batch, rng=None) -> metrics``
    (kosmosx_tpu/train/trainer.py:114-147): loss and gradients, the
    optimizer chain on the trainable parameters in place, and the metrics
    of ``loss_fn`` plus ``grad_norm``, the global norm of the trainable
    gradients before clipping. Frozen leaves are left bit-identical."""

    def train_step(model, batch, rng=None):
        (_, metrics), grads = value_and_grad(loss_fn, model, batch, rng, freeze)
        metrics = dict(metrics)
        metrics["grad_norm"] = optimizer.step(grads)
        return metrics

    return train_step


def lm_loss_fn(model_cfg, *, z_loss: float = 0.0) -> Callable:
    """Next-token CE for the text-only decoder
    (kosmosx_tpu/train/trainer.py:150-174); ``attention_mask`` becomes
    segment ids 0 / -1."""

    def loss_fn(model, batch, rng):
        tokens = batch["input_ids"]
        mask = batch.get("attention_mask")
        seg = None
        if mask is not None:
            seg = torch.where(mask > 0, 0, -1).to(torch.int32)
        logits = model.apply(tokens, segment_ids=seg, rng=rng)
        return next_token_loss(logits, tokens, mask, z_loss=z_loss)

    return loss_fn


def kosmos_loss_fn(kcfg, *, z_loss: float = 0.0) -> Callable:
    """Multimodal CE over ``{text_tokens, images}`` batches with the padding
    mask on (kosmosx_tpu/train/trainer.py:177-199)."""

    def loss_fn(model, batch, rng):
        logits = model.apply(batch["text_tokens"], batch["images"],
                             use_padding_mask=True, rng=rng)
        return multimodal_next_token_loss(
            logits, batch["text_tokens"], kcfg.image_embed_len,
            kcfg.splice_index, kcfg.decoder.padding_idx, z_loss=z_loss)

    return loss_fn


class Trainer:
    """The training loop (kosmosx_tpu/train/trainer.py:202-432) on one
    device, the card unless ``device="cpu"`` is asked for.
    ``init_fn(generator)`` builds the parameter tree (``Kosmos``,
    ``KosmosLanguage``) on that generator's device; ``loss_fn(model, batch,
    rng)`` returns ``(loss, metrics)``. ``state`` is ``{"params": model,
    "opt_state": optimizer, "step": int, "rng": generator}``."""

    def __init__(self, init_fn: Callable, loss_fn: Callable,
                 cfg: TrainConfig, mesh=None, device=None):
        if mesh is not None:
            raise not_ported("a device mesh", "Queue 1 item 10")
        cfg.check_supported()
        self.cfg = cfg
        self.device = torch.device("cuda" if device is None else device)
        self.schedule = make_schedule(cfg.schedule, cfg.learning_rate,
                                      cfg.total_steps, cfg.warmup_steps)
        self._init_fn = init_fn
        self._loss_fn = loss_fn
        self._step_fn = None
        self.optimizer = None
        self.state = None

    # -- state ---------------------------------------------------------------
    def init_state(self, initial_params=None) -> Dict[str, Any]:
        """Build the model from ``init_fn`` on a generator seeded with
        ``cfg.seed`` (or take ``initial_params``, a parameter-tree module),
        mark the trainable parameters and build the optimizer over them."""
        cfg = self.cfg
        rng = torch.Generator(device=self.device).manual_seed(cfg.seed)
        model = self._init_fn(rng) if initial_params is None \
            else initial_params
        model.set_trainable(cfg.freeze)
        trainable, _ = split_frozen(model, cfg.freeze)
        self.optimizer = make_optimizer(
            cfg.optimizer, self.schedule, trainable,
            weight_decay=cfg.weight_decay, beta1=cfg.beta1, beta2=cfg.beta2,
            grad_clip=cfg.grad_clip)
        self._step_fn = None
        self.state = {"params": model, "opt_state": self.optimizer,
                      "step": 0, "rng": rng}
        return self.state

    # -- step ---------------------------------------------------------------
    def _build_step(self) -> Callable:
        self._step_fn = make_train_step(self._loss_fn, self.optimizer,
                                        freeze=self.cfg.freeze)
        return self._step_fn

    def place_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch on the trainer's device (pinned, non-blocking)."""
        return to_device(batch, self.device)

    # -- eval ----------------------------------------------------------------
    def evaluate(self, eval_batches: Iterable[Dict[str, Any]]) -> Dict:
        """Mean loss and metrics over a validation set: no gradients, no
        rng, parameters untouched (kosmosx_tpu/train/trainer.py:323-357).
        The metrics' own ``loss`` is skipped (it is ``eval_loss``)."""
        total: Dict[str, float] = {}
        n = 0
        with torch.no_grad():
            for batch in eval_batches:
                loss, metrics = self._loss_fn(self.state["params"],
                                              self.place_batch(batch), None)
                total["eval_loss"] = total.get("eval_loss", 0.0) + float(loss)
                for k, v in metrics.items():
                    if k != "loss":
                        total[f"eval_{k}"] = total.get(f"eval_{k}", 0.0) + float(v)
                n += 1
        return {k: v / max(n, 1) for k, v in total.items()}

    # -- loop ----------------------------------------------------------------
    def run(self, batches: Iterable[Dict[str, Any]],
            steps: Optional[int] = None,
            log_fn: Optional[Callable[[int, Dict], None]] = None,
            eval_batches: Optional[Callable[[], Iterable]] = None):
        """Train over ``batches`` (at most ``steps`` of them); with
        ``cfg.resume``, from the newest checkpoint in ``cfg.output_dir``,
        skipping the batches it consumed. Logs every ``cfg.log_every`` steps
        and at the first (``loss_fn``'s metrics, ``grad_norm``, ``lr`` of
        the next step, ``steps_per_sec``), evaluates every
        ``cfg.eval_every`` and checkpoints every ``cfg.checkpoint_every``
        (kosmosx_tpu/train/trainer.py:360-428). Returns (state, metrics of
        the last step)."""
        cfg = self.cfg
        if self.state is None:
            self.init_state()
        if self._step_fn is None:
            self._build_step()

        start_step = 0
        if cfg.resume:
            found = ckpt.latest_checkpoint(cfg.output_dir)
            if found:
                path, start_step = found
                self.state = ckpt.restore_checkpoint(path, self.state)
                logger.info("resumed from %s (step %d)", path, start_step)

        def bounded():
            yielded = 0
            for i, b in enumerate(batches):
                if i < start_step:  # skip the batches the checkpoint consumed
                    continue
                if steps is not None and yielded >= steps:
                    return
                yield i, b
                yielded += 1

        def place(item):
            return item[0], self.place_batch(item[1])

        stream = device_prefetch(bounded(), place) if cfg.prefetch \
            else map(place, bounded())
        model, rng = self.state["params"], self.state["rng"]
        t0 = time.time()
        metrics: Dict[str, Any] = {}
        eval_metrics: Dict[str, float] = {}
        n = 0
        for i, batch in stream:
            metrics = self._step_fn(model, batch, rng)
            self.state["step"] += 1
            n += 1
            step_no = i + 1
            if cfg.eval_every and eval_batches is not None \
                    and step_no % cfg.eval_every == 0:
                eval_metrics = self.evaluate(eval_batches())
            if step_no % cfg.log_every == 0 or n == 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(eval_metrics)
                eval_metrics = {}
                m["lr"] = float(self.schedule(step_no))
                m["steps_per_sec"] = n / (time.time() - t0)
                if log_fn:
                    log_fn(step_no, m)
                else:
                    logger.info("step %d %s", step_no,
                                json.dumps({k: round(v, 5) for k, v in m.items()}))
            if cfg.checkpoint_every and step_no % cfg.checkpoint_every == 0:
                ckpt.save_checkpoint(self.state, cfg.output_dir, step_no)
        if cfg.final_save:
            ckpt.save_params(self.final_params(),
                             os.path.join(cfg.output_dir, "final"))
        return self.state, metrics

    def final_params(self):
        """Params to persist in the final consolidated save."""
        return self.state["params"]
