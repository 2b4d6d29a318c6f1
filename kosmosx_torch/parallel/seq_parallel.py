"""The sequence-parallel (context-parallel) training step (counterpart of
kosmosx_tpu/parallel/seq_parallel.py).

The sequence of a causal-LM step is sharded over a mesh dim
(``sequence``) on top of batch data parallelism (``data``): activations,
attention and logits live at L/S per rank, and the traffic is the ring
attention's K/V rotation (``parallel/ring_attention.py``) plus one
gradient all-reduce.

- Parameters and optimizer state are replicated. Each rank's loss is the
  weighted NLL of ITS positions over the global number of supervised
  positions, ``denom``, a constant of the batch (JAX's ``psum`` of the
  weights, :86-88); its gradient is the rank's share of the global
  gradient, and one SUM all-reduce of the gradients over ``data`` and
  ``sequence`` gives every rank the global gradient, and so the same
  update. JAX reaches the same gradient through the transpose of its
  loss's ``psum`` followed by a ``pmean`` (:131-136); torch's autograd
  transposes no collective, so the port sums instead.
- Labels are shifted over the GLOBAL sequence before sharding
  (``shift_labels``): a shard's last position is supervised by the next
  shard's first token.
- Inside the shard the decoder runs with ``cfg.sequence_axis`` set: the
  ring attention over the ``sequence`` group, and the shard's global
  positions (``position_offset``; a zigzag shard's per-position offsets).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from kosmosx_torch.core.config import MagnetoConfig
from kosmosx_torch.nn import decoder as dec
from kosmosx_torch.nn import layers
from kosmosx_torch.parallel.comm import all_reduce
from kosmosx_torch.parallel.mesh import build_mesh
from kosmosx_torch.parallel.ring_attention import (zigzag_permute,
                                                   zigzag_position_offsets)


def make_sp_mesh(data: int = 1, sequence: int = -1, devices=None):
    """A ``("data", "sequence")`` mesh over the processes (``devices``:
    the ranks it spans, default every process); ``sequence=-1`` takes the
    rest."""
    from kosmosx_torch.parallel.mesh import world_size

    n = world_size() if devices is None else len(devices)
    if sequence == -1:
        if n % data:
            raise ValueError(f"{n} processes do not split into data={data}")
        sequence = n // data
    return build_mesh((data, sequence), ("data", "sequence"), devices)


def shift_labels(tokens: torch.Tensor, pad_id: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global next-token labels and weights BEFORE sequence sharding:
    ``labels[:, t] = tokens[:, t+1]``, the last position ``pad_id`` with
    weight 0. Returns (labels, weights fp32), each (B, L)."""
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], pad_id)],
                       dim=1)
    weights = torch.ones(tokens.shape, dtype=torch.float32,
                         device=tokens.device)
    weights[:, -1] = 0.0
    return labels, weights


def _local_loss(model, tokens, labels, weights, segment_ids, denom,
                cfg: MagnetoConfig, group, offset, rng):
    """This rank's share of the global mean NLL (kosmosx_tpu/parallel/
    seq_parallel.py:64-88): the weighted NLL of its positions over the
    global ``denom``."""
    logits = dec.decoder_forward(model, tokens, cfg, segment_ids=segment_ids,
                                 rng=rng, position_offset=offset,
                                 sequence_group=group).float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.take_along_dim(logits, labels[..., None].long(),
                                      dim=-1)[..., 0]
    return ((logz - true_logit) * weights).sum() / denom


def make_seq_parallel_train_step(cfg: MagnetoConfig, optimizer, mesh, *,
                                 axis: str = "sequence",
                                 data_axis: str = "data") -> Callable:
    """``step(model, tokens, labels, weights, segment_ids=None, rng=None)
    -> loss``: one sequence-parallel step on the decoder ``model`` (a
    ``KosmosLanguage`` or a decoder parameter tree), in place.

    - ``cfg.sequence_axis`` must equal ``axis``; ``cfg.sequence_schedule``
      picks the ring. With ``"zigzag"`` the step permutes the global
      sequence into the zigzag layout itself (the loss is position-wise,
      so nothing is permuted back).
    - ``optimizer``: the update of the replicated parameters, an object
      whose ``step(grads)`` takes name -> gradient over ``model``'s
      trainable parameters and updates them in place
      (``train.optim.make_optimizer``'s, or any such).
    - ``tokens``/``labels``/``weights``/``segment_ids``: the GLOBAL (B, L)
      batch, the same on every rank; each rank takes its rows (over
      ``data_axis``) and positions (over ``axis``). ``segment_ids`` masks
      padded or packed batches (zeros by default).
    - ``rng``: a dropout key; each rank folds in its ``axis`` and then its
      ``data_axis`` index (JAX folds both axis indices, :124-126).
      Attention dropout takes the gathered path
      (``nn/attention._gathered_sp_attention``).

    Returns the global mean loss, the same on every rank."""
    if cfg.sequence_axis != axis:
        raise ValueError(f"cfg.sequence_axis={cfg.sequence_axis!r} must "
                         f"match axis={axis!r}")
    seq_group, data_group = mesh.get_group(axis), mesh.get_group(data_axis)
    s, n_data = mesh[axis].size(), mesh[data_axis].size()
    i, d_i = mesh.get_local_rank(axis), mesh.get_local_rank(data_axis)
    zigzag = cfg.sequence_schedule == "zigzag"

    def step(model, tokens, labels, weights, segment_ids=None,
             rng: Optional[int] = None):
        if segment_ids is None:
            segment_ids = torch.zeros(tokens.shape, dtype=torch.int32,
                                      device=tokens.device)
        batch = [tokens, labels, weights.float(), segment_ids]
        if zigzag:
            batch = [zigzag_permute(t, s) for t in batch]
        b, length = tokens.shape
        if b % n_data or length % s:
            raise ValueError(f"batch {tuple(tokens.shape)} does not split "
                             f"over {n_data} x {s} ranks")
        rows = slice(d_i * (b // n_data), (d_i + 1) * (b // n_data))
        lq = length // s
        cols = slice(i * lq, (i + 1) * lq)
        tok, lab, wts, seg = (t[rows, cols] for t in batch)
        offset = zigzag_position_offsets(i, lq, s, tokens.device) if zigzag \
            else i * lq
        denom = weights.float().sum().clamp_min(1.0)
        key = layers.fold_in(layers.fold_in(rng, i), d_i)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        loss = _local_loss(model, tok, lab, wts, seg, denom, cfg, seq_group,
                           offset, key)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        flat = [g if g is not None else torch.zeros_like(p)
                for g, (_, p) in zip(grads, named)] + [loss.detach()[None]]
        for group in (data_group, seq_group):
            flat = all_reduce(flat, group)
        optimizer.step({n: g for (n, _), g in zip(named, flat[:-1])})
        return flat[-1][0]

    return step
