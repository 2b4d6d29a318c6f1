"""Pipeline-parallel training steps over a ``pipe`` mesh dim, GPipe and
1F1B (counterpart of kosmosx_tpu/parallel/pipeline.py).

The decoder's layer list splits into ``S`` contiguous stages: stage ``i``
holds layers ``[i * L / S, (i + 1) * L / S)`` (``pipeline_stage`` keeps
only those in a rank's model, so their optimizer state lives there too);
the embeddings, positions, final LayerNorm and ``out_proj`` are
replicated. A step takes the GLOBAL ``(B, L)`` tokens, labels and weights
(labels shifted before the split, ``parallel.seq_parallel.shift_labels``)
and each ``data`` rank its rows, cut into ``M`` microbatches. Stage 0
embeds, every stage runs its layers, the last stage alone runs the final
LN and the vocabulary projection and its NLL over the GLOBAL weight count.
Activations move one stage forward and cotangents one stage back with
``parallel.comm.shift`` over the ``pipe`` group (point-to-point sends,
staged through the host under gloo), once per tick on every rank.

- GPipe (``make_pipeline_train_step``): ``T = M + S - 1`` forward ticks,
  each stage keeping every microbatch's autograd graph, then ``T``
  backward ticks in reverse order.
- 1F1B (``make_pipeline_train_step_1f1b``): ``T = M + 2S - 2`` ticks;
  stage ``i`` forwards microbatch ``j`` at tick ``i + j`` without a graph,
  keeping only its input in a ``min(2S - 1, M)``-slot stash, and at tick
  ``2(S - 1) - i + j`` recomputes the stage from the stash with a graph and
  runs its backward.

Gradients are summed over ``data`` for the layers' leaves and over
``data`` x ``pipe`` for the replicated ones (kosmosx_tpu/parallel/
pipeline.py:187-210,372-392), then the port's optimizer (``train/
optim.py``, or anything with ``step(grads)``) updates the stage's
parameters in place; an optimizer that clips sees the stage's leaves, as
the optax chain inside JAX's ``shard_map`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from kosmosx_torch.core.config import MagnetoConfig
from kosmosx_torch.nn import decoder as dec
from kosmosx_torch.nn import layers
from kosmosx_torch.nn.multiway import multiway_apply
from kosmosx_torch.parallel.comm import all_reduce, shift
from kosmosx_torch.parallel.mesh import build_mesh, world_size


def make_pp_mesh(data: int = 1, pipe: int = -1, devices=None):
    """A ``("data", "pipe")`` mesh over the processes (``devices``: the
    ranks it spans, default every process); ``pipe=-1`` takes the rest."""
    n = world_size() if devices is None else len(devices)
    if pipe == -1:
        if n % data:
            raise ValueError(f"{n} processes do not split into data={data}")
        pipe = n // data
    return build_mesh((data, pipe), ("data", "pipe"), devices)


def _under_layers(name: str) -> bool:
    return name.split(".", 1)[0] == "layers"


def pipeline_state_specs(state, *, axis: str = "pipe") -> Dict[str, Any]:
    """The spec of every leaf of ``{"params", "opt_state"}`` (a parameter
    module or a name -> tensor dict, and an optimizer with ``mu``/``nu``
    dicts): ``(axis,)`` for a leaf under ``layers`` (its stage holds it,
    and its moments), ``()`` for a replicated one."""
    def specs(named):
        return {n: (axis,) if _under_layers(n) else () for n in named}

    params = state["params"]
    names = [n for n, _ in params.named_parameters()] \
        if isinstance(params, nn.Module) else list(params)
    out = {"params": specs(names)}
    opt = state.get("opt_state")
    if opt is not None:
        opt = getattr(opt, "inner", opt)
        out["opt_state"] = {slot: specs(getattr(opt, slot))
                            for slot in ("mu", "nu") if getattr(opt, slot)}
    return out


def pipeline_stage(model: nn.Module, mesh, *, axis: str = "pipe"
                   ) -> nn.Module:
    """Keep this rank's stage of ``model``'s decoder layers, in place: its
    ``layers`` list becomes a ``ModuleDict`` of the stage's layers keyed by
    their indices in the whole stack, so parameter names stay the whole
    model's (``layers.6.attn.q.A.w``). Build the optimizer after it."""
    layer_list = model._modules["layers"]
    if isinstance(layer_list, nn.ModuleDict):
        return model
    s, n = mesh.get_local_rank(axis), mesh[axis].size()
    per = len(layer_list) // n
    model._modules["layers"] = nn.ModuleDict(
        {str(i): layer_list[i] for i in range(s * per, (s + 1) * per)})
    return model


def _check(cfg: MagnetoConfig, mesh, microbatches, axis: str):
    stages = mesh[axis].size()
    if not cfg.scan_layers:
        raise ValueError("pipeline parallelism needs cfg.scan_layers=True "
                         "(stacked (L, ...) layer params to shard)")
    if cfg.layers % stages != 0:
        raise ValueError(f"layers={cfg.layers} not divisible by "
                         f"pipe={stages}")
    if cfg.dropout or cfg.attention_dropout:
        raise ValueError("pipeline step does not thread dropout rngs")
    return stages, int(microbatches) if microbatches else stages


class _Stage:
    """One step's view of a rank's stage: its microbatches, its forward
    and loss, and the gradients it accumulates."""

    def __init__(self, model, cfg: MagnetoConfig, mesh, m: int, axis: str,
                 data_axis: str, tokens, labels, weights):
        layer_list = model["layers"]
        if not isinstance(layer_list, nn.ModuleDict):
            raise ValueError("the model holds every layer: cut it to its "
                             "stage with pipeline_stage(model, mesh) and "
                             "build the optimizer over what is left")
        self.model, self.cfg, self.m = model, cfg, m
        self.layers = list(layer_list.values())
        self.stages = mesh[axis].size()
        self.index = mesh.get_local_rank(axis)
        self.first, self.last = self.index == 0, self.index == self.stages - 1
        self.pipe = mesh.get_group(axis)
        self.data = mesh.get_group(data_axis)
        dev = next(model.parameters()).device
        rows = tokens.shape[0] // mesh[data_axis].size()
        lo = mesh.get_local_rank(data_axis) * rows

        def local(t):
            t = torch.as_tensor(t)[lo:lo + rows].to(dev)
            if rows % m:
                raise ValueError(f"{rows} rows a data rank do not split into "
                                 f"{m} microbatches")
            return t.reshape(m, rows // m, *t.shape[1:])

        self.tokens = local(tokens)
        self.labels = local(labels).long()
        self.weights = local(weights).float()
        # the global weight count: every pipe rank holds its data rank's
        # rows, so one data group's sum
        self.denom = all_reduce([self.weights.sum()], self.data)[0] \
            .clamp_min(1.0)
        self.params = {n: p for n, p in model.named_parameters()
                       if p.requires_grad}
        self.grads: Dict[str, torch.Tensor] = {}
        self.loss = torch.zeros((), device=dev)
        self.zeros = torch.zeros(
            (rows // m, self.tokens.shape[-1], cfg.embed_dim),
            dtype=cfg.dtype, device=dev)

    def forward(self, x_in: Optional[torch.Tensor], j: int) -> torch.Tensor:
        """The stage on microbatch ``j``: stage 0 embeds it, every stage
        runs its layers (checkpointed under ``cfg.remat``)."""
        cfg = self.cfg
        x = dec.forward_embedding(self.model, cfg, self.tokens[j])[0] \
            if self.first else x_in
        remat = cfg.remat and torch.is_grad_enabled()
        for lp in self.layers:
            if remat:
                x = checkpoint(dec._call_layer, lp, x, cfg,
                               use_reentrant=False,
                               context_fn=dec._REMAT_CONTEXTS[
                                   cfg.remat_policy])[0]
            else:
                x = dec._call_layer(lp, x, cfg)[0]
        return x

    def nll(self, h: torch.Tensor, j: int) -> torch.Tensor:
        """The last stage's share of the loss from microbatch ``j``: final
        LN, vocabulary projection, summed NLL over the global count."""
        cfg = self.cfg
        hn = multiway_apply(cfg.multiway, layers.layer_norm, self.model["ln"],
                            h, None)
        logits = dec.output_logits(self.model, hn, cfg).float()
        logz = torch.logsumexp(logits, dim=-1)
        true = torch.take_along_dim(logits, self.labels[j][..., None],
                                    dim=-1)[..., 0]
        return ((logz - true) * self.weights[j]).sum() / self.denom

    def backward(self, out: torch.Tensor, cot: Optional[torch.Tensor],
                 x_in: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Accumulate the stage's parameter gradients of ``out`` under the
        cotangent ``cot`` (None: ``out`` is the loss), and return the
        cotangent of its input ``x_in`` (None on stage 0)."""
        names = list(self.params)
        inputs = [self.params[n] for n in names]
        if x_in is not None:
            inputs.append(x_in)
        got = torch.autograd.grad([out], inputs, None if cot is None
                                  else [cot.to(out.dtype)],
                                  allow_unused=True)
        for n, g in zip(names, got):
            if g is not None:
                self.grads[n] = g if n not in self.grads \
                    else self.grads[n] + g
        return None if x_in is None else got[-1]

    def send(self, t: Optional[torch.Tensor], direction: int):
        """One tick's shift over ``pipe`` (zeros where the rank has
        nothing to send)."""
        return shift([self.zeros if t is None else t.detach()], self.pipe,
                     direction)[0]

    def finish(self, optimizer) -> torch.Tensor:
        """The gradients summed over ``data`` (layer leaves) or ``data`` x
        ``pipe`` (replicated leaves), the optimizer step, the loss."""
        grads = {n: self.grads.get(n, torch.zeros_like(p))
                 for n, p in self.params.items()}
        staged = [n for n in grads if _under_layers(n)]
        shared = [n for n in grads if not _under_layers(n)]
        for names, group in ((staged, self.data),
                             (shared, (self.data, self.pipe))):
            if names:
                grads.update(zip(names, all_reduce([grads[n] for n in names],
                                                   group)))
        optimizer.step(grads)
        return all_reduce([self.loss], (self.data, self.pipe))[0]


def make_pipeline_train_step(cfg: MagnetoConfig, optimizer, mesh, *,
                             microbatches: Optional[int] = None,
                             axis: str = "pipe",
                             data_axis: str = "data") -> Callable:
    """GPipe: ``step(model, tokens, labels, weights) -> loss`` (the global
    mean NLL before the update) over a ``pipeline_stage``'d model,
    ``optimizer.step(grads)`` on its parameters. ``cfg.scan_layers`` must
    be set and ``cfg.layers`` divisible by the stages, dropout 0 (JAX's
    conditions, kosmosx_tpu/parallel/pipeline.py:123-130); ``tokens``
    (B, L) with B divisible by ``data * microbatches`` (default: the
    stage count)."""
    stages, m = _check(cfg, mesh, microbatches, axis)
    ticks = m + stages - 1

    def step(model, tokens, labels, weights):
        st = _Stage(model, cfg, mesh, m, axis, data_axis, tokens, labels,
                    weights)
        kept = {}
        recv = st.zeros
        for t in range(ticks):
            j = t - st.index
            y = None
            if 0 <= j < m:
                x_in = None if st.first else recv.requires_grad_()
                y = st.forward(x_in, j)
                if st.last:
                    loss = st.nll(y, j)
                    st.loss = st.loss + loss.detach()
                    kept[j] = (x_in, loss)
                    y = None
                else:
                    kept[j] = (x_in, y)
            recv = st.send(y, 1)
        cot = st.zeros
        for t in reversed(range(ticks)):
            j = t - st.index
            dx = None
            if 0 <= j < m:
                x_in, out = kept.pop(j)
                dx = st.backward(out, None if st.last else cot, x_in)
            cot = st.send(dx, -1)
        return st.finish(optimizer)

    step.num_ticks = ticks
    return step


def make_pipeline_train_step_1f1b(cfg: MagnetoConfig, optimizer, mesh, *,
                                  microbatches: Optional[int] = None,
                                  axis: str = "pipe",
                                  data_axis: str = "data") -> Callable:
    """1F1B: ``step(model, tokens, labels, weights) -> loss`` as
    ``make_pipeline_train_step``'s, scheduled forward and backward tick by
    tick (kosmosx_tpu/parallel/pipeline.py:238-409): ``step.num_ticks`` is
    ``M + 2S - 2`` and ``step.stash_slots`` ``min(2S - 1, M)``, the stage
    inputs a stage keeps; each backward tick recomputes its stage."""
    stages, m = _check(cfg, mesh, microbatches, axis)
    ticks = m + 2 * stages - 2
    slots = min(2 * stages - 1, m)

    def step(model, tokens, labels, weights):
        st = _Stage(model, cfg, mesh, m, axis, data_axis, tokens, labels,
                    weights)
        stash = [None] * slots
        recv, cot = st.zeros, st.zeros
        for t in range(ticks):
            j_f = t - st.index
            y = None
            if 0 <= j_f < m:
                stash[j_f % slots] = recv
                if not st.last:   # the last stage's output goes nowhere
                    with torch.no_grad():
                        y = st.forward(None if st.first else recv, j_f)
            j_b = t - (2 * (stages - 1) - st.index)
            dx = None
            if 0 <= j_b < m:
                x_in = None if st.first else \
                    stash[j_b % slots].detach().requires_grad_()
                h = st.forward(x_in, j_b)
                if st.last:
                    h = st.nll(h, j_b)
                    st.loss = st.loss + h.detach()
                dx = st.backward(h, None if st.last else cot, x_in)
            recv, cot = st.send(y, 1), st.send(dx, -1)
        return st.finish(optimizer)

    step.num_ticks = ticks
    step.stash_slots = slots
    return step

