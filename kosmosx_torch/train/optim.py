"""Optimizers and learning-rate schedules (counterpart of
kosmosx_tpu/train/optim.py), with optax's semantics.

``make_optimizer`` builds the chain the JAX package builds (:127-162):
global-norm clipping, then Lion, AdamW, StableAdamW or the 8-bit AdamW and
Lion of kosmosx_tpu/train/quant.py:57-149 with decoupled weight decay on
the leaves ``weight_decay_mask`` selects, then the learning rate from the
schedule. ``Optimizer.step`` runs that chain leaf by leaf and updates the
parameters in place, so no second copy of the updates is held; Lion over
leaves on the card runs it in three launches over every leaf instead
(``ops/lion.py``: the global norm's sums, then the clip, Lion and the
decay in one pass), the same arithmetic: with the same norm, the same bits.
``MultiSteps`` wraps it for gradient accumulation (``optax.MultiSteps``).

Things optax does that a port easily gets wrong:

- Lion and AdamW read the schedule at their own 0-based count, and every
  schedule warms up from 0.0, so the first step applies no update
  (``scale_by_learning_rate``). StableAdamW and the 8-bit kinds read it
  at count + 1 (optim.py:79, quant.py:80,124).
- The 8-bit kinds keep their moments only as blockwise codes and scales
  (``train/quant.py``): each step dequantises a leaf's moments, updates
  them in fp32 and quantizes them again. Their arithmetic is JAX's term
  for term (``(1 - b2) * g * g``, not ``g ** 2``), and every division by a
  step constant divides by a device tensor, so the codes match JAX's bit
  for bit on the card too.
- A parameter that gets no gradient (``None``: the multiway B expert,
  which no position routes through) takes a zero one, as JAX's ``grad``
  gives: its moments still decay and masked weight decay still moves it.
- Clipping: ``g`` if ``norm < max`` else ``(g / norm) * max``.

Over sharded leaves (``shards``: name -> ``parallel/sharding.LocalShard``:
an FSDP run, a ``tensor`` or ``expert`` cut, or a run within a cut) each
rank updates its piece of every leaf. The elementwise kinds need nothing
more; what spans a whole leaf is reduced over the shard's groups: the
global norm's sum of squares (a whole leaf's counted once), StableAdamW's
RMS, and the 8-bit kinds' block absmax (``train/quant.py``), so the codes
are the whole leaf's.
``state_dict`` then gathers the single-process state (every rank must
call it) and ``load_state_dict`` takes one and keeps each rank's run.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from kosmosx_torch.ops import lion
from kosmosx_torch.train.quant import (BLOCK, dequantize_blockwise, lead,
                                       quantize_blockwise)
from kosmosx_torch.utils import trace

OPTIMIZERS = ("lion", "adamw", "stable_adamw", "adamw8bit", "lion8bit")
# the kinds whose schedule reads count + 1 (the rest read count)
_READ_NEXT_COUNT = ("stable_adamw", "adamw8bit", "lion8bit")
_F32 = np.float32

# ---------------------------------------------------------------------------
# decay / no-decay masking (kosmosx_tpu/train/optim.py:28-44)
# ---------------------------------------------------------------------------


_NO_DECAY = ("scale", "bias", "b", "table", "class_embedding", "latents",
             "media_pos_emb")


def weight_decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """True where weight decay applies, by the last component of the
    parameter's path: matmul weights of two or more dims. LayerNorm scales
    and biases, linear biases (``b``), embedding tables and the learned
    ``class_embedding``, ``latents`` and ``media_pos_emb`` take none."""
    return {name: name.rsplit(".", 1)[-1] not in _NO_DECAY and p.ndim >= 2
            for name, p in params.items()}


# ---------------------------------------------------------------------------
# schedules (kosmosx_tpu/train/optim.py:100-120 over optax's schedules),
# in float32 as optax computes them
# ---------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    if steps <= 0:
        return lambda count: float(_F32(init))

    def schedule(count):
        c = _F32(min(max(count, 0), steps))
        frac = _F32(1) - c / _F32(steps)
        return float((_F32(init) - _F32(end)) * frac + _F32(end))
    return schedule


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with exponent 1."""
    if steps <= 0:
        raise ValueError(f"the cosine schedule needs positive decay steps, "
                         f"got {steps}")

    def schedule(count):
        c = _F32(min(count, steps))
        cos = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(steps)))
        return float(_F32(init) * ((_F32(1) - _F32(alpha)) * cos + _F32(alpha)))
    return schedule


def _join(first, second, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules of two schedules at ``boundary``."""
    return lambda count: first(count) if count < boundary else \
        second(count - boundary)


def make_schedule(name: str, learning_rate: float, total_steps: int,
                  warmup_steps: Optional[int] = None,
                  final_scale: float = 0.0) -> Callable[[int], float]:
    """``cosine``, ``linear`` or ``constant``, each with a linear warmup from
    0.0 over ``warmup_steps`` (default 1% of ``total_steps``, at least 1)."""
    warmup = warmup_steps if warmup_steps is not None else \
        max(total_steps // 100, 1)
    if name == "cosine":
        alpha = 0.0 if learning_rate == 0.0 else \
            learning_rate * final_scale / learning_rate
        return _join(_linear(0.0, learning_rate, warmup),
                     _cosine(learning_rate, total_steps - warmup, alpha),
                     warmup)
    if name == "linear":
        return _join(_linear(0.0, learning_rate, warmup),
                     _linear(learning_rate, learning_rate * final_scale,
                             max(total_steps - warmup, 1)), warmup)
    if name == "constant":
        return _join(_linear(0.0, learning_rate, warmup),
                     lambda count: float(_F32(learning_rate)), warmup)
    raise ValueError(f"unknown schedule: {name}")


# ---------------------------------------------------------------------------
# clipping
# ---------------------------------------------------------------------------


def tree_order(names) -> list:
    """Parameter names in the order ``jax.tree_util`` flattens the JAX tree
    (dict keys sorted, list indices in order), the order optax sums the
    leaves' squares in."""
    return sorted(names, key=lambda n: tuple(
        int(c) if c.isdigit() else c for c in n.split(".")))


def global_norm(grads: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in the dict's order
    (optax.global_norm, given ``tree_order``); a ``None`` gradient counts as
    zeros."""
    present = [g for g in grads.values() if g is not None]
    if not present:
        return torch.zeros(())
    return torch.sqrt(sum(g.float().square().sum() for g in present))


def clip_by_global_norm(g: torch.Tensor, norm: torch.Tensor,
                        max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on one leaf, given the global ``norm``: the
    leaf unchanged if ``norm < max_norm``, else ``(g / norm) * max_norm``
    with the norm in the leaf's dtype."""
    return torch.where(norm < max_norm, g, (g / norm.to(g.dtype)) * max_norm)


# ---------------------------------------------------------------------------
# the optimizer chain (kosmosx_tpu/train/optim.py:127-162)
# ---------------------------------------------------------------------------


def _ema(decay: float, g: Optional[torch.Tensor], t: torch.Tensor):
    """``(1 - decay) * g + decay * t`` (optax.tree.update_moment); a missing
    gradient is zero."""
    return decay * t if g is None else (1 - decay) * g + decay * t


class Optimizer:
    """Global-norm clipping followed by Lion, AdamW (optax's ``scale_by_adam``,
    eps 1e-8, eps_root 0), StableAdamW (:58-97), or AdamW8bit / Lion8bit
    (kosmosx_tpu/train/quant.py:57-149), each with decoupled weight decay
    on the masked leaves, over a dict of named parameters.

    ``step(grads)`` updates the parameters in place and returns the global
    norm of the gradients before clipping. The state (``count`` and the
    moments ``mu``, and ``nu`` for the Adam kinds: tensors like the
    parameters, or for the 8-bit kinds ``{"q", "scale"}`` codes, int8 for
    ``mu`` and uint8 for ``nu``) is ``state_dict()``. ``shards``: the
    ``LocalShard`` of each parameter that is a rank's run of an FSDP leaf
    (``params`` then holds the local runs)."""

    def __init__(self, params: Dict[str, torch.Tensor], name: str,
                 schedule: Callable[[int], float], *,
                 weight_decay: float = 0.1, beta1: float = 0.9,
                 beta2: float = 0.95, grad_clip: Optional[float] = 1.0,
                 mask: Optional[Dict[str, bool]] = None,
                 shards: Optional[Dict[str, object]] = None):
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer: {name}")
        self.name = name
        self.params = dict(params)
        self.shards = {n: (shards or {}).get(n) for n in self.params}
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b1, self.b2 = beta1, beta2
        self.eps = 1e-8
        self.grad_clip = grad_clip
        self.mask = weight_decay_mask(self.params) if mask is None else mask
        self.order = tree_order(self.params)
        self.count = 0
        if name.endswith("8bit"):
            self.mu = {n: quantize_blockwise(torch.zeros_like(p), signed=True,
                                             shard=self.shards[n])
                       for n, p in self.params.items()}
            self.nu = {} if name == "lion8bit" else \
                {n: quantize_blockwise(torch.zeros_like(p), signed=False,
                                       shard=self.shards[n])
                 for n, p in self.params.items()}
        else:
            self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
            self.nu = {} if name == "lion" else \
                {n: torch.zeros_like(p) for n, p in self.params.items()}
        self._update = {"lion": self._lion, "adamw": self._adamw,
                        "stable_adamw": self._stable_adamw,
                        "adamw8bit": self._adamw8bit,
                        "lion8bit": self._lion8bit}[name]
        self._consts = None
        self._lion_table = None   # the kernels' table (Lion on the card)
        self._groups = None

    def _bias_correction(self, decay: float, count: int) -> float:
        """``1 - decay**count`` in float32, as optax computes it."""
        return float(_F32(1) - _F32(decay) ** _F32(count))

    def _fused(self) -> bool:
        """Whether ``step`` runs the multi-tensor kernels
        (``ops/lion.py``): Lion over leaves on the card."""
        return self.name == "lion" and bool(self.params) and \
            next(iter(self.params.values())).is_cuda

    def _table(self):
        """The kernels' table of the leaves, built again where a parameter
        or a moment has moved."""
        params = [self.params[n] for n in self.order]
        moments = [self.mu[n] for n in self.order]
        if self._lion_table is None or \
                not self._lion_table.current(params, moments):
            self._lion_table = lion.LeafTable(
                params, moments, [self.mask[n] for n in self.order],
                [self.shards[n] is None for n in self.order])
        return self._lion_table

    def norm(self, grads: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """The global norm of ``grads`` (over every shard of every leaf):
        each leaf's sum of squares is summed over the ranks that hold its
        other pieces, a whole leaf's is counted once. Lion over leaves on
        the card sums them in two launches (``ops/lion.lion_norm``) and
        leaves the gradients in the kernels' table for ``step``."""
        if self._fused():
            return self._fused_norm(grads)
        if not any(sh is not None for sh in self.shards.values()):
            return global_norm({n: grads.get(n) for n in self.order})
        from kosmosx_torch.parallel.comm import all_reduce

        dev = next(iter(self.params.values())).device
        by_group: Dict = {}
        for n in self.order:
            g = grads.get(n)
            shard = self.shards[n]
            key = None if shard is None else shard.group
            sq = by_group.setdefault(key, torch.zeros((), device=dev))
            if g is not None:
                by_group[key] = sq + g.float().square().sum()
        total = by_group.pop(None, torch.zeros((), device=dev))
        for group, sq in by_group.items():
            total = total + all_reduce([sq], group)[0]
        return torch.sqrt(total)

    def _fused_norm(self, grads) -> torch.Tensor:
        table = self._table()
        table.grads([grads.get(n) for n in self.order])
        out = lion.lion_norm(table)
        if all(sh is None for sh in self.shards.values()):
            return out[0]
        from kosmosx_torch.parallel.comm import all_reduce

        # the pieces of sharded leaves: their sums of squares over each
        # shard group's ranks
        total = out[1]
        for group, index in self._shard_groups(table.device).items():
            total = total + all_reduce([table.leaf_sq[index].sum()],
                                       group)[0]
        return torch.sqrt(total)

    def _shard_groups(self, dev) -> Dict:
        """Each shard group's leaves, as positions in ``order`` on ``dev``."""
        if self._groups is None:
            by_group: Dict = {}
            for i, n in enumerate(self.order):
                if self.shards[n] is not None:
                    by_group.setdefault(self.shards[n].group, []).append(i)
            self._groups = {
                group: torch.tensor(index).pin_memory().to(dev,
                                                           non_blocking=True)
                for group, index in by_group.items()}
        return self._groups

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        fused = self._fused()
        launched = lion.lion.launches
        with trace.span("train.clip", device=True):
            norm = self.norm(grads)
        count = self.count
        if self.name in _READ_NEXT_COUNT:
            lr = self.schedule(count + 1)
        else:
            lr = self.schedule(count)
        if self.name == "adamw8bit":
            # the bias corrections as 0-d device tensors, divided by exactly
            dev = next(iter(self.params.values())).device
            self._consts = tuple(
                torch.full((), self._bias_correction(b, count + 1), device=dev)
                for b in (self.b1, self.b2))
        with trace.span("train.update", device=True) as sp:
            if sp.on:
                sp.set(**self._traffic(grads))
            if fused:
                lion.lion(self._lion_table, norm, lr=lr, b1=self.b1,
                          b2=self.b2, weight_decay=self.weight_decay,
                          max_norm=self.grad_clip)
                if sp.on:
                    sp.set(chunks=self._lion_table.chunks,
                           launches=lion.lion.launches - launched)
            else:
                self._step_leaves(grads, norm, lr, count)
        self.count = count + 1
        return norm

    def _step_leaves(self, grads, norm: torch.Tensor, lr: float,
                     count: int) -> None:
        """The update a leaf at a time, clipped by ``norm``: each leaf's
        gradient is scaled by the clip as its update reads it."""
        for name, p in self.params.items():
            g = grads.get(name)
            if g is not None and self.grad_clip is not None:
                g = clip_by_global_norm(g, norm.to(g.device), self.grad_clip)
            decay = self.weight_decay if self.mask[name] else 0.0
            p.add_(self._update(name, p, g, decay, lr, count))

    def _traffic(self, grads) -> Dict[str, int]:
        """What the update spans record: its leaves, and the bytes of the
        parameters, of their moments and of the gradients the step got."""
        def size(t):
            return t.numel() * t.element_size()
        return {"leaves": len(self.params),
                "param_bytes": sum(size(p) for p in self.params.values()),
                "moment_bytes": self.moment_bytes(),
                "grad_bytes": sum(size(grads[n]) for n in self.params
                                  if grads.get(n) is not None)}

    def _lion(self, name, p, g, decay, lr, count):
        """optax.scale_by_lion, add_decayed_weights, scale_by_learning_rate."""
        m = self.mu[name]
        u = torch.sign(_ema(self.b1, g, m))
        m.copy_(_ema(self.b2, g, m))
        if decay:
            u = u + decay * p
        return u * (-lr)

    def _adamw(self, name, p, g, decay, lr, count):
        """optax.scale_by_adam, add_decayed_weights, scale_by_learning_rate."""
        mu, nu = self.mu[name], self.nu[name]
        mu.copy_(_ema(self.b1, g, mu))
        nu.copy_(_ema(self.b2, None if g is None else g ** 2, nu))
        mu_hat = mu / self._bias_correction(self.b1, count + 1)
        nu_hat = nu / self._bias_correction(self.b2, count + 1)
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if decay:
            u = u + decay * p
        return u * (-lr)

    def _stable_adamw(self, name, p, g, decay, lr, count):
        """kosmosx_tpu/train/optim.py:58-97: AdamW whose update is divided by
        max(1, RMS(update)) per parameter."""
        mu, nu = self.mu[name], self.nu[name]
        if g is None:
            mu.copy_(self.b1 * mu)
            nu.copy_(self.b2 * nu)
        else:
            mu.copy_(self.b1 * mu + (1 - self.b1) * g)
            nu.copy_(self.b2 * nu + (1 - self.b2) * g * g)
        u = (mu / self._bias_correction(self.b1, count + 1)) / (
            torch.sqrt(nu / self._bias_correction(self.b2, count + 1))
            + self.eps)
        shard = self.shards[name]
        if shard is None:
            mean_sq = u.square().mean()
        else:
            from kosmosx_torch.parallel.comm import all_reduce

            mean_sq = all_reduce([u.square().sum()], shard.group)[0] \
                / shard.numel
        rms = torch.sqrt(mean_sq + 1e-16)
        u = u / torch.clamp(rms, min=1.0)
        return -lr * (u + decay * p)

    def _adamw8bit(self, name, p, g, decay, lr, count):
        """kosmosx_tpu/train/quant.py:57-112: AdamW on dequantised moments,
        stored again as codes."""
        b1c, b2c = self._consts
        shard = self.shards[name]
        m = dequantize_blockwise(self.mu[name], p.shape, shard)
        v = dequantize_blockwise(self.nu[name], p.shape, shard)
        g = None if g is None else g.float()
        m = _ema(self.b1, g, m)
        v = self.b2 * v if g is None else self.b2 * v + (1 - self.b2) * g * g
        u = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
        self.mu[name] = quantize_blockwise(m, signed=True, shard=shard)
        self.nu[name] = quantize_blockwise(v, signed=False, shard=shard)
        if decay:
            u = u + decay * p.float()
        return (u * (-lr)).to(p.dtype)

    def _lion8bit(self, name, p, g, decay, lr, count):
        """kosmosx_tpu/train/quant.py:115-149: Lion on the dequantised
        momentum, stored again as codes."""
        shard = self.shards[name]
        m = dequantize_blockwise(self.mu[name], p.shape, shard)
        g = None if g is None else g.float()
        u = torch.sign(_ema(self.b1, g, m))
        self.mu[name] = quantize_blockwise(_ema(self.b2, g, m), signed=True,
                                           shard=shard)
        if decay:
            u = u + decay * p.float()
        return (u * (-lr)).to(p.dtype)

    def moment_bytes(self) -> int:
        """Bytes of the moments (codes and scales for the 8-bit kinds)."""
        def size(t):
            return t.numel() * t.element_size()
        return sum(size(x) for slot in (self.mu, self.nu)
                   for m in slot.values()
                   for x in (m.values() if isinstance(m, dict) else (m,)))

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of a rank's piece ``t`` of parameter ``name`` (a
        collective over its shard's groups; ``t`` itself when whole)."""
        from kosmosx_torch.parallel.sharding import whole

        return whole(t, self.shards[name])

    def piece(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole leaf ``full`` of ``name``."""
        from kosmosx_torch.parallel.sharding import local_piece

        return local_piece(full, self.shards[name], self.params[name].shape)

    def _full_codes(self, name: str, qs: Dict[str, torch.Tensor]):
        """The whole leaf's ``{"q", "scale"}`` from a rank's local blocks:
        codes put in place (SUM over zeros), scales by block (MAX; a cut
        leaf's scales are the whole leaf's already)."""
        shard = self.shards[name]
        if shard is None:
            return qs
        from kosmosx_torch.parallel.comm import all_reduce

        n = self.params[name].numel()
        total = -(-shard.numel // BLOCK)
        codes = qs["q"].new_zeros(total * BLOCK, dtype=torch.int32)
        if shard.cuts:
            codes[shard.flat_index(n, codes.device)] = \
                qs["q"].reshape(-1).to(torch.int32)
            codes = all_reduce([codes], shard.group)[0]
            return {"q": codes.to(qs["q"].dtype).reshape(total, BLOCK),
                    "scale": qs["scale"]}
        first, left = shard.offset // BLOCK, lead(shard, n)
        codes[shard.offset:shard.offset + n] = \
            qs["q"].reshape(-1)[left:left + n].to(torch.int32)
        scale = qs["scale"].new_zeros(total)
        scale[first:first + qs["scale"].shape[0]] = qs["scale"][:, 0]
        codes = all_reduce([codes], shard.group)[0]
        scale = all_reduce([scale], shard.group,
                           op=torch.distributed.ReduceOp.MAX)[0]
        return {"q": codes.to(qs["q"].dtype).reshape(total, BLOCK),
                "scale": scale[:, None]}

    def _local_codes(self, name: str, qs: Dict[str, torch.Tensor]):
        """A rank's local blocks of the whole leaf's ``{"q", "scale"}``."""
        shard = self.shards[name]
        if shard is None:
            return qs
        n = self.params[name].numel()
        if shard.cuts:
            idx = shard.flat_index(n, qs["q"].device)
            return {"q": qs["q"].reshape(-1)[idx], "scale": qs["scale"]}
        first, left = shard.offset // BLOCK, lead(shard, n)
        nblocks = -(-(left + n) // BLOCK) if n else 0
        codes = qs["q"].reshape(-1)[shard.offset:shard.offset + n]
        codes = torch.nn.functional.pad(codes.to(torch.int32),
                                        (left, nblocks * BLOCK - left - n))
        return {"q": codes.to(qs["q"].dtype).reshape(nblocks, BLOCK),
                "scale": qs["scale"][first:first + nblocks]}

    def state_dict(self) -> Dict:
        """``count`` and the moments ``mu``/``nu``, of the whole leaves
        (gathered over the shards: every rank must call it)."""
        def whole(name, t):
            return self._full_codes(name, t) if isinstance(t, dict) \
                else self.full(name, t)
        return {"count": self.count,
                "mu": {n: whole(n, t) for n, t in self.mu.items()},
                "nu": {n: whole(n, t) for n, t in self.nu.items()}}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self._lion_table = None
        for slot in ("mu", "nu"):
            own = getattr(self, slot)
            if set(own) != set(state[slot]):
                raise ValueError(f"optimizer state {slot!r} does not match "
                                 f"the parameters")
            for n, t in state[slot].items():
                if isinstance(t, dict):
                    t = self._local_codes(n, {k: x.to(own[n][k].device)
                                              for k, x in t.items()})
                    for part, x in t.items():
                        own[n][part].copy_(x)
                else:
                    own[n].copy_(self.piece(n, t.to(own[n].device)))


def make_optimizer(name: str, schedule: Callable[[int], float],
                   params: Dict[str, torch.Tensor], *,
                   weight_decay: float = 0.1, beta1: float = 0.9,
                   beta2: float = 0.95, grad_clip: Optional[float] = 1.0,
                   shards: Optional[Dict[str, object]] = None) -> Optimizer:
    """name in ``OPTIMIZERS`` over ``params`` (name -> parameter), with the
    reference's defaults: Lion (wd 0.1, betas 0.9 and 0.95) and clipping at
    1.0 (kosmosx_tpu/train/optim.py:127-162); ``shards`` as
    ``Optimizer``'s."""
    return Optimizer(params, name, schedule, weight_decay=weight_decay,
                     beta1=beta1, beta2=beta2, grad_clip=grad_clip,
                     shards=shards)


class MultiSteps:
    """Gradient accumulation with ``optax.MultiSteps(opt, k)`` semantics
    (the mean, ``use_grad_mean=True``): each ``step(grads)`` folds the
    micro-step's gradients into the running mean ``acc + (g - acc) /
    (mini_step + 1)`` (a missing gradient counts as zeros); every k-th
    applies the inner optimizer, clipping included, to the mean and resets
    it, and the others leave the parameters alone. The inner schedule
    counts inner updates. ``step`` returns the norm of the micro-step's own
    gradients, the ``grad_norm`` JAX logs (kosmosx_tpu/train/trainer.py:142).
    The accumulator has the parameters' dtype and device."""

    def __init__(self, inner: Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be at least 1, got {every_k}")
        self.inner = inner
        self.every_k = every_k
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = {n: torch.zeros_like(p) for n, p in inner.params.items()}

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.inner.params

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        norm = self.inner.norm(grads)
        n_acc = self.acc[next(iter(self.acc))].new_full(
            (), float(self.mini_step + 1)) if self.acc else None
        for name, acc in self.acc.items():
            g = grads.get(name)
            acc.add_(((acc.neg() if g is None else g - acc) / n_acc)
                     .to(acc.dtype))
        if self.mini_step == self.every_k - 1:
            self.inner.step(self.acc)
            for acc in self.acc.values():
                acc.zero_()
            self.mini_step = 0
            self.gradient_step += 1
        else:
            self.mini_step += 1
        return norm

    def moment_bytes(self) -> int:
        return self.inner.moment_bytes()

    def state_dict(self) -> Dict:
        """The counters, the inner state and the accumulator; at an update
        boundary (``mini_step`` 0) the accumulator is all zeros and is left
        out (``None``), which keeps a full-width checkpoint one fp32 copy
        of the parameters smaller."""
        return {"mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "acc": {n: self.inner.full(n, t) for n, t in self.acc.items()}
                if self.mini_step else None,
                "inner": self.inner.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        acc = state["acc"]
        if acc is not None and set(self.acc) != set(acc):
            raise ValueError("the accumulator does not match the parameters")
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])
        for n, t in self.acc.items():
            if acc is None:
                t.zero_()
            else:
                t.copy_(self.inner.piece(n, acc[n].to(t.device)))
        self.inner.load_state_dict(state["inner"])
