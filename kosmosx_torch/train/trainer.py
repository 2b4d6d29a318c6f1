"""Training (counterpart of kosmosx_tpu/train/trainer.py).

The JAX package jits one SPMD train step over a mesh; here the step is eager
PyTorch: the loss and its gradients with autograd (the flash attention
kernels' backward included), the pre-clip global norm, and the optimizer
chain applied in place (with ``grad_accum > 1`` through
``optim.MultiSteps``, as JAX wraps it in ``optax.MultiSteps``). A parameter
tree's top-level subtrees named in ``TrainConfig.freeze`` take no gradient
and no optimizer state, so autograd saves no activations for their
backward. Each step draws its dropout key from the state's generator
(``nn/layers.rng_key``) and passes it to the loss, so every step,
micro-steps included, drops out afresh, and a resumed generator continues
the sequence.

Over a mesh of processes (``parallel.mesh.make_mesh``, from ``cfg.data``
and ``cfg.fsdp`` by default once the process group is up) every rank holds
its rows of the global batch (``parallel.sharding.shard_batch``, over
``data`` x ``fsdp``; with ``per_process_batches`` its own batch) and its
loss is its share of the global batch's loss (``train/loss.global_batch``),
so the SUM of the ranks' gradients is the global gradient, as JAX's GSPMD
step computes it. With ``fsdp == 1`` the parameters and optimizer state are
replicated and the gradients all-reduced; with ``fsdp > 1`` FSDP2 shards
them (``parallel.sharding.shard_params``), the gradients are
reduce-scattered and each rank updates its run of every leaf. With
``tensor`` or ``expert`` > 1 the decoder layers are cut first
(``parallel/tensor.py``): ranks that differ only in those dims hold the
same rows and compute the same loss, each rank keeps its slice of every
cut leaf (and its optimizer state), and the gradient norm sums each cut
leaf's squares over its ranks and a whole leaf's once. Checkpoints hold
the whole state in the single-process format, written by rank 0.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from kosmosx_torch.nn import layers
from kosmosx_torch.parallel.comm import all_reduce
from kosmosx_torch.parallel.mesh import make_mesh, world_size
from kosmosx_torch.parallel.sharding import (batch_shards, param_shards,
                                             shard_batch, shard_params)
from kosmosx_torch.parallel.tensor import mark_batch
from kosmosx_torch.train import checkpoint as ckpt
from kosmosx_torch.train.data import device_prefetch, to_device
from kosmosx_torch.train.loss import (global_batch, global_sum,
                                      multimodal_next_token_loss,
                                      next_token_loss)
from kosmosx_torch.train.optim import MultiSteps, make_optimizer, make_schedule
from kosmosx_torch.utils import trace

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors kosmosx_tpu/train/trainer.py:39-92: same fields, same
    defaults (field comments there)."""

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


def split_frozen(params, freeze) -> Tuple[Dict[str, torch.Tensor],
                                          Dict[str, torch.Tensor]]:
    """(trainable, frozen) named parameters of a parameter tree, split by
    top-level key (kosmosx_tpu/train/trainer.py:105-111)."""
    trainable, frozen = {}, {}
    for name, p in params.named_parameters():
        (frozen if name.split(".", 1)[0] in freeze else trainable)[name] = p
    return trainable, frozen


def value_and_grad(loss_fn: Callable, model, batch,
                   rng: Optional[torch.Generator] = None, freeze: tuple = ()):
    """``((loss, metrics), grads)`` of ``loss_fn(model, batch, key)`` with
    respect to the trainable parameters (name -> gradient, ``None`` for a
    parameter the loss does not reach), ``key`` the dropout key drawn from
    the generator ``rng`` (None without one). Frozen subtrees get
    ``requires_grad=False``, so their forward records nothing."""
    model.set_trainable(freeze)
    trainable, _ = split_frozen(model, freeze)
    with trace.span("train.forward", device=True):
        loss, metrics = loss_fn(model, batch, layers.rng_key(rng))
    with trace.span("train.backward", device=True):
        grads = torch.autograd.grad(loss, list(trainable.values()),
                                    allow_unused=True)
    return (loss.detach(), metrics), dict(zip(trainable, grads))


def make_train_step(loss_fn: Callable, optimizer,
                    freeze: tuple = ()) -> Callable:
    """``step(model, batch, rng=None) -> metrics``
    (kosmosx_tpu/train/trainer.py:114-147): loss and gradients, the
    optimizer chain (an ``Optimizer`` or ``MultiSteps``) on the trainable
    parameters in place, and the metrics of ``loss_fn`` plus ``grad_norm``,
    the global norm of this step's trainable gradients before clipping.
    Frozen leaves are left bit-identical."""

    def train_step(model, batch, rng=None):
        (_, metrics), grads = value_and_grad(loss_fn, model, batch, rng, freeze)
        metrics = dict(metrics)
        with trace.span("train.optimizer", device=True):
            metrics["grad_norm"] = optimizer.step(grads)
        return metrics

    return train_step


def _add_moe_aux(loss_and_metrics, aux):
    """``(loss + aux, metrics + moe_aux)`` for an MoE decoder's routing
    loss ``aux``, else unchanged (kosmosx_tpu/train/trainer.py:161-170,
    183-192)."""
    if aux is None:
        return loss_and_metrics
    loss, metrics = loss_and_metrics
    # over a mesh ``aux`` is the rank's share of the global batch's routing
    # loss (the layers are marked with ``mark_batch``), as ``loss`` is of
    # its cross-entropy
    return loss + aux, {**metrics, "moe_aux": global_sum(aux)}


def lm_loss_fn(model_cfg, *, z_loss: float = 0.0) -> Callable:
    """Next-token CE for the text-only decoder
    (kosmosx_tpu/train/trainer.py:150-174); ``attention_mask`` becomes
    segment ids 0 / -1. With ``moe_experts > 0`` the routing loss is added
    to the loss and reported as ``moe_aux``."""
    moe = model_cfg.moe_experts > 0

    def loss_fn(model, batch, rng):
        tokens = batch["input_ids"]
        mask = batch.get("attention_mask")
        seg = None
        if mask is not None:
            seg = torch.where(mask > 0, 0, -1).to(torch.int32)
        out = model.apply(tokens, segment_ids=seg, rng=rng, with_aux=moe)
        logits, aux = out if moe else (out, None)
        return _add_moe_aux(next_token_loss(logits, tokens, mask,
                                            z_loss=z_loss), aux)

    return loss_fn


def kosmos_loss_fn(kcfg, *, z_loss: float = 0.0) -> Callable:
    """Multimodal CE over ``{text_tokens, images}`` batches with the padding
    mask on (kosmosx_tpu/train/trainer.py:177-199), plus ``moe_aux`` as
    ``lm_loss_fn`` adds it."""
    moe = kcfg.decoder.moe_experts > 0

    def loss_fn(model, batch, rng):
        out = model.apply(batch["text_tokens"], batch["images"],
                          use_padding_mask=True, rng=rng, with_aux=moe)
        logits, aux = out if moe else (out, None)
        return _add_moe_aux(multimodal_next_token_loss(
            logits, batch["text_tokens"], kcfg.image_embed_len,
            kcfg.splice_index, kcfg.decoder.padding_idx, z_loss=z_loss), aux)

    return loss_fn


class Trainer:
    """The training loop (kosmosx_tpu/train/trainer.py:202-432) on one
    device, the card unless ``device="cpu"`` is asked for, or on one
    device in each process of a mesh (``mesh``, default
    ``make_mesh(cfg.data, cfg.fsdp, cfg.tensor, cfg.expert)`` once the
    process group holds more than one process). ``init_fn(generator)`` builds the parameter tree
    (``Kosmos``, ``KosmosLanguage``) on that generator's device, the same
    on every rank; ``loss_fn(model, batch, rng)`` returns ``(loss,
    metrics)``, over a mesh the rank's share of the global batch's loss
    (the port's losses are, under ``train/loss.global_batch``). ``state``
    is ``{"params": model, "opt_state": optimizer, "step": int, "rng":
    generator}``; with ``cfg.grad_accum > 1`` the optimizer is
    ``MultiSteps`` over it, the step counts micro-steps and the schedule
    inner updates."""

    def __init__(self, init_fn: Callable, loss_fn: Callable,
                 cfg: TrainConfig, mesh=None, device=None):
        self.cfg = cfg
        if mesh is None and (world_size() > 1 or cfg.data > 1
                             or cfg.fsdp > 1 or cfg.tensor > 1
                             or cfg.expert > 1):
            mesh = make_mesh(data=cfg.data, fsdp=cfg.fsdp, tensor=cfg.tensor,
                             expert=cfg.expert)
        self.mesh = mesh
        self.device = torch.device("cuda" if device is None else device)
        self.schedule = make_schedule(cfg.schedule, cfg.learning_rate,
                                      cfg.total_steps, cfg.warmup_steps)
        self._init_fn = init_fn
        self._loss_fn = loss_fn
        self._step_fn = None
        self._run_step = None
        self._root = None
        self._trainable = None
        self.optimizer = None
        self.state = None

    # -- mesh ----------------------------------------------------------------
    @property
    def batch_group(self):
        """The process groups the global batch is split over (``data``,
        ``fsdp``), or None without a mesh."""
        if self.mesh is None:
            return None
        return tuple(self.mesh.get_group(a) for a in ("data", "fsdp")
                     if self.mesh[a].size() > 1)

    @property
    def sharded(self) -> bool:
        """Whether FSDP shards the parameters (``fsdp`` > 1)."""
        return self.mesh is not None and self.mesh["fsdp"].size() > 1

    def reduce_grads(self, grads: Dict[str, Optional[torch.Tensor]]):
        """The ranks' gradients summed over the batch's groups (the data
        parallel all-reduce), one collective per group."""
        names = [n for n, g in grads.items() if g is not None]
        summed = all_reduce([grads[n] for n in names], self.batch_group)
        return {**grads, **dict(zip(names, summed))}

    def is_writer(self) -> bool:
        """Whether this rank writes files: rank 0 of the mesh."""
        return self.mesh is None or not any(self.mesh.get_coordinate())

    # -- state ---------------------------------------------------------------
    def init_state(self, initial_params=None) -> Dict[str, Any]:
        """Build the model from ``init_fn`` on a generator seeded with
        ``cfg.seed`` (or take ``initial_params``, a parameter-tree module),
        mark the trainable parameters and build the optimizer over them;
        over a mesh place the model first (``shard_params``: the ``tensor``
        and ``expert`` cuts, FSDP with ``fsdp`` > 1), each rank's optimizer
        then holding its pieces of the leaves."""
        cfg = self.cfg
        rng = torch.Generator(device=self.device).manual_seed(cfg.seed)
        model = self._init_fn(rng) if initial_params is None \
            else initial_params
        model.set_trainable(cfg.freeze)
        trainable, _ = split_frozen(model, cfg.freeze)
        shards = None
        if self.mesh is not None:
            if self.sharded and self.device.type == "cuda" \
                    and self.mesh.device_type != "cuda":
                raise ValueError("FSDP on the card needs NCCL: one card per "
                                 "process")
            self._root = shard_params(model, self.mesh)
            mark_batch(model, self.batch_group)
            trainable = {n: p for n, p in model.named_parameters()
                         if n in trainable}
            shards = param_shards(model, trainable)
        self._trainable = trainable
        if self.sharded:
            with torch.no_grad():
                trainable = {n: p.to_local() for n, p in trainable.items()}
        self.optimizer = self.build_optimizer(trainable, shards)
        self._step_fn = None
        self.state = {"params": model, "opt_state": self.optimizer,
                      "step": 0, "rng": rng}
        return self.state

    def build_optimizer(self, params: Dict[str, torch.Tensor], shards=None):
        """The configured optimizer chain over ``params`` (name ->
        tensor), under ``MultiSteps`` with ``cfg.grad_accum > 1``;
        ``shards`` as ``optim.Optimizer``'s."""
        cfg = self.cfg
        opt = make_optimizer(
            cfg.optimizer, self.schedule, params,
            weight_decay=cfg.weight_decay, beta1=cfg.beta1, beta2=cfg.beta2,
            grad_clip=cfg.grad_clip, shards=shards)
        return MultiSteps(opt, cfg.grad_accum) if cfg.grad_accum > 1 else opt

    # -- step ---------------------------------------------------------------
    def _build_step(self) -> Callable:
        """``step(model, batch, rng) -> metrics``; ``run`` calls
        ``_run_step(batch)`` over it."""
        if self.mesh is not None:
            step = self._mesh_step
        else:
            step = make_train_step(self._loss_fn, self.optimizer,
                                   freeze=self.cfg.freeze)

        def run_step(batch):
            metrics = step(self.state["params"], batch, self.state["rng"])
            self.state["step"] += 1
            return metrics

        self._run_step = run_step
        self._step_fn = step
        return step

    def _mesh_step(self, model, batch, rng):
        """One step over the mesh: the loss of this rank's rows (its share
        of the global loss), the gradients summed over the ranks (FSDP's
        reduce-scatter, or the all-reduce), the optimizer on this rank's
        parameters or runs of them. The dropout key folds in the rank's
        batch shard, so the ranks' rows drop out differently."""
        key = layers.fold_in(layers.rng_key(rng), batch_shards(self.mesh)[0])
        with global_batch(self.batch_group):
            if self._root is not None:
                with trace.span("train.forward", device=True):
                    loss, metrics = self._root(self._loss_fn, batch, key)
                with trace.span("train.backward", device=True):
                    loss.backward()
                grads = {}
                for n, p in self._trainable.items():
                    grads[n] = None if p.grad is None else p.grad.to_local()
                    p.grad = None
            else:
                with trace.span("train.forward", device=True):
                    loss, metrics = self._loss_fn(model, batch, key)
                with trace.span("train.backward", device=True):
                    grads = torch.autograd.grad(
                        loss, list(self._trainable.values()),
                        allow_unused=True)
                    grads = self.reduce_grads(
                        dict(zip(self._trainable, grads)))
        metrics = dict(metrics)
        with trace.span("train.optimizer", device=True):
            metrics["grad_norm"] = self.optimizer.step(grads)
        return metrics

    def place_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's part of a host batch (``shard_batch``) on the
        trainer's device (pinned, non-blocking)."""
        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh,
                                per_process=self.cfg.per_process_batches)
        return to_device(batch, self.device)

    # -- eval ----------------------------------------------------------------
    def evaluate(self, eval_batches: Iterable[Dict[str, Any]],
                 model=None) -> Dict:
        """Mean loss and metrics over a validation set: no gradients, no
        rng, parameters untouched (kosmosx_tpu/train/trainer.py:323-357),
        of ``model`` (default the state's). The metrics' own ``loss`` is
        skipped (it is ``eval_loss``)."""
        model = self.state["params"] if model is None else model
        total: Dict[str, float] = {}
        n = 0
        with torch.no_grad(), global_batch(self.batch_group):
            for batch in eval_batches:
                batch = self.place_batch(batch)
                loss, metrics = self._root(self._loss_fn, batch, None) \
                    if self._root is not None and model is \
                    self.state["params"] else self._loss_fn(model, batch, None)
                loss = global_sum(loss)
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
        """Train over ``batches`` (at most ``steps`` of them, each a
        micro-step under ``grad_accum``); with ``cfg.resume``, from the
        newest checkpoint in ``cfg.output_dir``, skipping the batches it
        consumed. Logs every ``cfg.log_every`` steps and at the first
        (``loss_fn``'s metrics, ``grad_norm``, ``lr`` of the schedule at the
        next micro-step's number, as JAX logs it, ``steps_per_sec``),
        evaluates every
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

        stream = iter(device_prefetch(bounded(), place) if cfg.prefetch
                      else map(place, bounded()))
        t0 = time.time()
        metrics: Dict[str, Any] = {}
        eval_metrics: Dict[str, float] = {}
        n = 0
        while True:
            # a turn of the loop: the next batch and, if there is one, its
            # step (the last turn finds the stream ended)
            with trace.span("train.step", device=True) as sp:
                with trace.span("train.data", device=True):
                    item = next(stream, None)
                if item is None:
                    break
                i, batch = item
                step_no = i + 1
                sp.set(step=step_no)
                with global_batch(self.batch_group):
                    metrics = self._run_step(batch)
                n += 1
                if cfg.eval_every and eval_batches is not None \
                        and step_no % cfg.eval_every == 0:
                    eval_metrics = self.evaluate(eval_batches())
                if step_no % cfg.log_every == 0 or n == 1:
                    with trace.span("train.log"):
                        m = {k: float(v) for k, v in metrics.items()}
                        m.update(eval_metrics)
                        eval_metrics = {}
                        m["lr"] = float(self.schedule(step_no))
                        m["steps_per_sec"] = n / (time.time() - t0)
                        if log_fn:
                            log_fn(step_no, m)
                        else:
                            logger.info("step %d %s", step_no, json.dumps(
                                {k: round(v, 5) for k, v in m.items()}))
                if cfg.checkpoint_every \
                        and step_no % cfg.checkpoint_every == 0:
                    with trace.span("train.checkpoint"):
                        ckpt.save_checkpoint(self.state, cfg.output_dir,
                                             step_no, writer=self.is_writer(),
                                             group=self.batch_group)
        if cfg.final_save:
            with trace.span("train.checkpoint"):
                ckpt.save_params(self.final_params(),
                                 os.path.join(cfg.output_dir, "final"),
                                 writer=self.is_writer(),
                                 group=self.batch_group)
        return self.state, metrics

    def final_params(self):
        """Params to persist in the final consolidated save."""
        return self.state["params"]
