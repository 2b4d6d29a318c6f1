"""Window driver ``train``: the port's ``Trainer`` on ``kosmos_loss_fn``.

Set-up builds one ``Trainer`` on the benchmark's weights and drives it
through its first ``check_steps`` steps with the window's own call
(``Trainer.run``) and feed; those steps warm every shape up and give the
numbers the reference checks. The window then runs the same object for
``--seconds``. Each step's batch is drawn on the card from the seed, every
row new.

Compared with the float32 reference (``perfbench/reference``), which runs
the same steps from the same weights once the window has closed and the
program is freed:

- ``loss_gap``: the largest gap of a step's loss (printed, and compared
  only where the cell's limits file gives it a limit: see ``PERF.md``);
- ``grad_gap``: the first step's clipped gradient as the optimizer got it
  (its Lion moment over ``1 - beta2``), the worst leaf's gap of norms over
  the reference's norm of that leaf or of the median leaf, the larger;
- ``change_gap``: the same of each leaf's change over the steps, leaves
  whose reference gradient is under a thousandth of the median leaf's
  left out (they move by round-off alone);
- ``grad_diff``: the first step's gradient again, but the worst leaf's
  norm of the two sides' difference, element by element, over the same
  denominator; ``grad_diff_all`` (printed) the same over all leaves;
- ``change_diff``: the norm of the two sides' difference of the change
  over the steps, over all the leaves kept, over the reference's norm of
  those leaves. Over all leaves and not by the worst: Lion's step is
  lr * sign, so a leaf whose gradient sits near round-off moves at
  random on either side and its own gap reads near 1.
A gap of norms cannot see a direction (Lion's step has the same norm
whatever its signs); a difference can. Each side keeps, of every leaf,
its values at a sample of ``SAMPLE`` positions drawn from the seed and the
leaf's name, scaled so that the sample's norm estimates the leaf's.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Dict, Iterator

import torch

from perfbench import roofline, trace, weights
from perfbench.harness import Context, Outcome
from perfbench.window import Pacer, Readings, free, peak_bytes, sync

_EXCLUDE_BELOW = 1e-3
SAMPLE = 16384


class Feed:
    """The training batches of one seed, drawn on the device in order."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.gen = weights.generator(device, seed, "batches")
        self.shape = (traffic["batch"], traffic["text_len"])
        self.vocab = cfg["decoder"]["vocab_size"]
        self.size = cfg["vision"]["image_size"]
        self.device = device

    def next(self) -> Dict[str, torch.Tensor]:
        toks = weights.tokens(self.gen, self.shape, self.vocab, self.device)
        imgs = weights.pixels(self.gen, self.shape[0], self.size, self.device)
        return {"text_tokens": toks, "images": imgs}

    def take(self, n: int) -> Iterator[Dict[str, torch.Tensor]]:
        for _ in range(n):
            yield self.next()

    def paced(self, pacer: Pacer, counter: list) -> Iterator:
        while pacer.more():
            counter[0] += 1
            yield self.next()


def sample(seed: int, path: str, t: torch.Tensor) -> torch.Tensor:
    """``t``'s values at the leaf's seeded positions (all of them where it
    has no more than ``SAMPLE``), on the host in float32, times
    sqrt(elements / sample): the sample's norm estimates the leaf's."""
    flat = t.detach().reshape(-1)
    n = flat.numel()
    if n > SAMPLE:
        gen = weights.generator(flat.device, seed, "sample", path)
        flat = flat[torch.randint(n, (SAMPLE,), generator=gen,
                                  device=flat.device)]
        return flat.float().cpu() * (n / SAMPLE) ** 0.5
    return flat.float().cpu()


def changes(cfg: dict, seed: int, now: Dict[str, torch.Tensor], device):
    """Each leaf's ``now - initial``, the initial weights drawn again chunk
    by chunk from the seed: its norm, and its sample."""
    norms, samples = {}, {}
    for _, part in weights.iter_chunks(cfg, seed, device, torch.float32):
        for path, init in part.items():
            if path in now:
                d = now[path].detach().float() - init
                norms[path] = float(d.norm())
                samples[path] = sample(seed, path, d)
                del d
        del part
    return norms, samples


def median_reached(norms: Dict[str, float]) -> float:
    """The median leaf's norm among the leaves the loss reaches (the
    multiway B experts, which no position routes through, get none)."""
    return statistics.median(v for v in norms.values() if v > 0)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None
              ) -> Dict[str, float]:
    """Each leaf's gap of norms, over the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    median = median_reached(ref)
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], median)
            for n in ref if keep is None or keep(n)}


def leaf_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               ref_norms: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's norm of the two sides' difference (by their samples),
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger; a leaf the program lacks reads as zeros."""
    median = median_reached(ref_norms)
    return {n: float((prog[n] - r).norm() if n in prog else r.norm())
            / max(ref_norms[n], median) for n, r in ref.items()}


def total_diff(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep=None) -> float:
    """The norm of the two sides' difference over all the leaves kept (by
    their samples), over the reference's norm of the same leaves."""
    num = den = 0.0
    for n, r in ref.items():
        if keep is None or keep(n):
            num += float(((prog[n] - r) if n in prog else r).square().sum())
            den += float(r.square().sum())
    return (num / den) ** 0.5


def worst(gaps: Dict[str, float]) -> str:
    return max(gaps, key=gaps.get)


def _trainer(ctx: Context, model, kcfg):
    from kosmosx_torch.train.trainer import (TrainConfig, Trainer,
                                             kosmos_loss_fn)

    tr = ctx.cell.traffic
    loss_fn = kosmos_loss_fn(kcfg)
    if ctx.faults.get("half_batch"):
        base = loss_fn

        def loss_fn(m, batch, rng):   # noqa: F811  (the planted fault)
            half = batch["text_tokens"].shape[0] // 2
            return base(m, {k: v[:half] for k, v in batch.items()}, rng)

    if ctx.faults.get("ascent"):
        descent = loss_fn

        def loss_fn(m, batch, rng):   # noqa: F811  (the planted fault)
            loss, metrics = descent(m, batch, rng)
            return -loss, metrics

    cfg = TrainConfig(
        batch_size=tr["batch"], seq_len=tr["text_len"],
        seed=weights.mix(ctx.seed, "trainer"),
        learning_rate=tr["learning_rate"], weight_decay=tr["weight_decay"],
        beta1=tr["beta1"], beta2=tr["beta2"], grad_clip=tr["grad_clip"],
        optimizer=tr["optimizer"], schedule="constant", warmup_steps=0,
        prefetch=False, checkpoint_every=0, log_every=1 << 30,
        freeze=tuple(tr["freeze"]))
    trainer = Trainer(lambda g: model, loss_fn, cfg, device=ctx.device)
    trainer.init_state()
    if ctx.faults.get("unchanged_state"):
        opt = trainer.optimizer
        opt.step = lambda grads: opt.norm(grads)   # the planted fault
    return trainer


def run(ctx: Context) -> Outcome:
    from perfbench import port

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    kcfg = port.kosmos_config(cfg, remat=True,
                              remat_policy=tr["remat_policy"])
    model = port.build_model(kcfg, weights.make_weights(
        cfg, ctx.seed, dev, getattr(torch, tr["master_weights"])))
    trainer = _trainer(ctx, model, kcfg)
    feed = Feed(cfg, tr, ctx.seed, dev)
    losses = []

    def log(step, metrics):
        losses.append(metrics["loss"])

    n_check = tr["check_steps"]
    grad_norms = grad_samples = None
    for i in range(n_check):
        trainer.run(feed.take(1), log_fn=log)
        if i == 0:
            scale = 1.0 / (1.0 - tr["beta2"])
            grad_norms = {n: float(m.norm()) * scale
                          for n, m in trainer.optimizer.mu.items()}
            grad_samples = {n: sample(ctx.seed, n, m) * scale
                            for n, m in trainer.optimizer.mu.items()}
    change_norms, change_samples = changes(cfg, ctx.seed,
                                           trainer.optimizer.params, dev)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    positions = tr["batch"] * (tr["text_len"] + cfg["image_embed_len"])
    step_flops = tr["batch"] * roofline.sequence_flops(
        cfg, tr["text_len"] + cfg["image_embed_len"], 1, train=True)
    steps = [0]
    pacer = Pacer(dev, ctx.seconds)
    trainer.run(feed.paced(pacer, steps))
    window_s = pacer.close()
    peak = peak_bytes(dev)

    readings = None
    if ctx.trace:
        readings = Readings(window_s, steps[0],
                            steps[0] * step_flops)
        spans = trace.Spans()
        trace.install(spans)
        spans.phase(trainer, "_run_step", "Trainer.step")
        before = trace.launch_counts(spans)
        with trace.profiled([trace.FLASH_FWD, trace.FLASH_BWD, trace.OPTIMIZER,
                             "Trainer.step"], dev) as box:
            trainer.run(feed.take(tr["profile_steps"]))
        trace.check_spans(spans, before, dev)
        spans.remove()
        readings.profile = box["profile"]
        readings.profile_steps = tr["profile_steps"]
        readings.calls = spans.calls

    del trainer, model
    free(dev)
    ref = reference(ctx)
    readings_all = gaps({"losses": losses, "grads": grad_norms,
                         "changes": change_norms,
                         "grad_samples": grad_samples,
                         "change_samples": change_samples}, ref)
    print("train: " + json.dumps(readings_all), file=sys.stderr)
    compared = {k: v for k, v in readings_all.items() if k in ctx.cell.limits}
    return Outcome(attempted=steps[0], failed=0,
                   e2e={"train_tokens_per_s": steps[0] * positions / window_s,
                        "setup_s": setup_s},
                   compared=compared, memory_peak_bytes=peak,
                   readings=readings)


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared: ``prog`` and ``ref`` as ``reference`` gives
    them (the program's losses, first-step gradient norms and samples,
    change norms and samples under the same keys)."""
    moved = ref["moved"]
    found = {
        "grad_gap": leaf_gaps(prog["grads"], ref["grads"]),
        "change_gap": leaf_gaps(prog["changes"], ref["changes"], keep=moved),
        "grad_diff": leaf_diffs(prog["grad_samples"], ref["grad_samples"],
                                ref["grads"]),
    }
    print("train: worst leaves: " + ", ".join(
        f"{k} {worst(v)}" for k, v in found.items()), file=sys.stderr)
    out = {"loss_gap": max(abs(a - b) for a, b in zip(prog["losses"],
                                                      ref["losses"]))}
    out.update({k: v[worst(v)] for k, v in found.items()})
    out["grad_diff_all"] = total_diff(prog["grad_samples"],
                                      ref["grad_samples"])
    out["change_diff"] = total_diff(prog["change_samples"],
                                    ref["change_samples"], keep=moved)
    return out


def control(ctx: Context, precisions) -> dict:
    """The controls' readings: the reference's steps at each of
    ``precisions`` in the program's place."""
    ref = reference(ctx)
    return {f"control:{p}": gaps(reference(ctx, p), ref) for p in precisions}


def reference(ctx: Context, precision: str = "fp32") -> dict:
    """The reference's ``check_steps`` steps from the same weights and
    batches: losses, the first step's clipped gradient norms and samples,
    each leaf's change norm and sample, and which leaves the change
    comparisons keep."""
    from perfbench.reference import kosmos as ref

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    ref.strict_fp32()
    p = ref.prepare(weights.make_weights(cfg, ctx.seed, dev), precision,
                    cfg["decoder"]["layers"])
    leaves = ref.trainable_paths(p, frozen=tuple(tr["freeze"]))
    opt = ref.Lion(leaves, lr=tr["learning_rate"], beta1=tr["beta1"],
                   beta2=tr["beta2"], weight_decay=tr["weight_decay"],
                   clip=tr["grad_clip"])
    lin = ref.Lin(precision)
    feed = Feed(cfg, tr, ctx.seed, dev)
    losses, first = [], None
    for i in range(tr["check_steps"]):
        loss, grads = ref.loss_and_grads(p, cfg, feed.next(), lin, leaves)
        clipped = opt.step(grads)
        losses.append(loss)
        if i == 0:
            first = {k: float(g.norm()) for k, g in clipped.items()}
            first_samples = {k: sample(ctx.seed, k, g)
                             for k, g in clipped.items()}
            raw = {k: float(g.norm()) for k, g in grads.items()}
        del grads, clipped
    change_norms, change_samples = changes(cfg, ctx.seed, leaves, dev)
    median = median_reached(raw)
    moved = {k for k, v in raw.items() if v >= _EXCLUDE_BELOW * median}
    del p, leaves, opt
    free(dev)
    return {"losses": losses, "grads": first, "grad_samples": first_samples,
            "changes": change_norms, "change_samples": change_samples,
            "moved": moved.__contains__}
