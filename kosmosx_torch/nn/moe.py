"""Token-routed mixture-of-experts FFN (counterpart of kosmosx_tpu/nn/moe.py).

Switch/GShard semantics as in JAX: an fp32 router, greedy top-k routing
without replacement, per-group (batch row) capacity with slots taken in
token order, overflow tokens dropped (their output is zero, so the residual
passes them through), pads routed nowhere, and the Switch load-balance loss
plus the router z-loss as one fp32 scalar.

The dispatch is the GPU's, not the MXU's. JAX contracts the tokens with a
one-hot ``(G, T, E, C)`` dispatch tensor and the outputs with the combine
tensor (kosmosx_tpu/nn/moe.py:171,190), which costs ``2 G T E C D`` FLOPs
each way for a permutation. Here every kept ``(token, choice)`` is
scattered by its slot index into an ``(E, G, C, D)`` buffer, each expert
matrix is one batched product over E (``torch.bmm``, cuBLAS: JAX's expert
products are plain einsums, no Pallas kernel), and the outputs are
gathered back by the same index and mixed with the gates in fp32. The
function and its gradients are JAX's: the gates carry the router's
gradient and the dispatch is not differentiated. Dropped choices go to a
spare row past the buffer that nothing reads, so no shape depends on the
data and nothing waits on the device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from kosmosx_torch.core import initializers as init
from kosmosx_torch.nn import layers
from kosmosx_torch.parallel import tensor as tpar
from kosmosx_torch.parallel.comm import all_reduce


def init_moe_ffn(gen, embed_dim: int, ffn_dim: int, num_experts: int, *,
                 subln: bool = True, device=None) -> Dict[str, Any]:
    """Router ``(D, E)`` and the experts' fc1/fc2 (and sub-LN) stacked on a
    leading ``(E, ...)`` axis, each expert's weights an independent xavier
    draw (kosmosx_tpu/nn/moe.py:42-70)."""
    router = init.xavier_uniform(gen, (embed_dim, num_experts), device=device)
    experts = {
        "fc1": {"w": torch.stack([init.xavier_uniform(
                    gen, (embed_dim, ffn_dim), device=device)
                    for _ in range(num_experts)]),
                "b": init.zeros((num_experts, ffn_dim), device)},
        "fc2": {"w": torch.stack([init.xavier_uniform(
                    gen, (ffn_dim, embed_dim), device=device)
                    for _ in range(num_experts)]),
                "b": init.zeros((num_experts, embed_dim), device)},
    }
    if subln:
        experts["ffn_ln"] = {"scale": init.ones((num_experts, ffn_dim), device),
                             "bias": init.zeros((num_experts, ffn_dim), device)}
    return {"router": {"w": router}, "experts": experts}


def find_moe_ffn(tree: Any, path: str = "") -> Optional[str]:
    """The path of the first MoE FFN (a dict holding ``router`` and
    ``experts``) in a nested dict/list tree, or None."""
    if isinstance(tree, dict) and "router" in tree and "experts" in tree:
        return path
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (list, tuple)) else ()
    for k, v in items:
        found = find_moe_ffn(v, f"{path}.{k}" if path else str(k))
        if found is not None:
            return found
    return None


def moe_capacity(tokens_per_group: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert and group (kosmosx_tpu/nn/moe.py:73-77)."""
    return max(1, int(math.ceil(
        top_k * tokens_per_group / num_experts * capacity_factor)))


def _routing(probs: torch.Tensor, num_experts: int, top_k: int,
             capacity: int, valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """probs (G, T, E) -> (expert, slot, gate), each (top_k, G, T): choice
    i of token t in group g goes to slot ``slot`` of expert ``expert`` with
    weight ``gate``, 0 where it was dropped or the token is a pad
    (kosmosx_tpu/nn/moe.py:80-111, whose combine tensor holds ``gate`` at
    ``[g, t, expert, slot]``).

    Greedy top-k without replacement (``argmax`` takes the first maximum,
    as ``jnp.argmax`` does); slots in token order by a cumulative count, so
    earlier tokens keep theirs on overflow; pads (``valid`` False) take no
    slot."""
    g, t, e = probs.shape
    counts = torch.zeros((g, e), dtype=torch.long, device=probs.device)
    p = probs
    experts, slots, gates = [], [], []
    for _ in range(top_k):
        idx = p.argmax(dim=-1)                                    # (G, T)
        gate = p.gather(-1, idx[..., None])[..., 0]
        oh = F.one_hot(idx, e)                                    # (G, T, E)
        if valid is not None:
            oh = oh * valid[..., None].long()
        pos = oh.cumsum(dim=1) - 1 + counts[:, None, :]
        counts = counts + oh.sum(dim=1)
        slot = (oh * pos).sum(dim=-1)
        keep = (slot < capacity) & (oh.sum(dim=-1) > 0)
        experts.append(idx)
        slots.append(slot)
        gates.append(torch.where(keep, gate, torch.zeros_like(gate)))
        p = p * (1 - oh.to(p.dtype))
    return torch.stack(experts), torch.stack(slots), torch.stack(gates)


def _aux_loss(logits: torch.Tensor, probs: torch.Tensor, top1: torch.Tensor,
              num_experts: int, aux_weight: float, z_weight: float,
              valid: Optional[torch.Tensor], batch_group=None) -> torch.Tensor:
    """``aux_weight * E * sum(f * p_mean) + z_weight * mean(lse^2)`` over
    the valid tokens (kosmosx_tpu/nn/moe.py:148-164), fp32.

    ``batch_group``: the process group(s) a training batch is split over.
    The loss is then the rank's SHARE of the global batch's, so that the
    ranks' shares sum to the loss of the global batch in value and in
    gradient: the expert counts ``sum(onehot * w)`` and the valid count
    ``D`` are summed over the ranks (detached: ``f`` has no gradient), and
    the loss is linear in the rank's own ``sum(probs * w)`` and ``sum(z *
    w)`` once they are known."""
    onehot = F.one_hot(top1.reshape(-1), num_experts).float()
    probs = probs.reshape(-1, num_experts)
    z = torch.logsumexp(logits, dim=-1).reshape(-1).square()
    w = torch.ones_like(z) if valid is None else valid.float().reshape(-1)
    counts, denom = (onehot * w[:, None]).sum(dim=0), w.sum()
    if batch_group is not None:
        counts, denom = all_reduce([counts, denom], batch_group)
    denom = denom.clamp_min(1.0)
    lb_loss = num_experts * ((counts / denom)
                             * ((probs * w[:, None]).sum(dim=0) / denom)).sum()
    z_loss = (z * w).sum() / denom
    return (aux_weight * lb_loss + z_weight * z_loss).float()


def _expert_ffn(ex, h: torch.Tensor, activation: str,
                activation_fp32: bool, tensor=None) -> torch.Tensor:
    """The experts' FFN on their buffers h (E, N, D): fc1, the activation,
    the per-expert sub-LN in h's dtype (kosmosx_tpu/nn/moe.py:181-186),
    fc2; one batched product per matrix. ``tensor``: the experts' fc1 and
    sub-LN hold this rank's columns and fc2 its rows (Megatron's layout,
    ``parallel/tensor.py``)."""
    dt = h.dtype
    act = layers.activation_fn(activation)
    h = tpar.copy_to(h, tensor)
    h = torch.bmm(h, ex["fc1"]["w"].to(dt)) + ex["fc1"]["b"].to(dt)[:, None]
    h = act(h.float()).to(dt) if activation_fp32 else act(h)
    if "ffn_ln" in ex:
        tot = h.shape[-1] * (tensor.size if tensor else 1)
        mean = tpar.all_sum(h.sum(dim=-1, keepdim=True), tensor) / tot
        var = tpar.all_sum((h - mean).square().sum(dim=-1, keepdim=True),
                           tensor) / tot
        h = ((h - mean) * torch.rsqrt(var + 1e-5)
             * ex["ffn_ln"]["scale"].to(dt)[:, None]
             + ex["ffn_ln"]["bias"].to(dt)[:, None])
    h = tpar.reduce_from(torch.bmm(h, ex["fc2"]["w"].to(dt)), tensor)
    return h + ex["fc2"]["b"].to(dt)[:, None]


def moe_ffn(params, x: torch.Tensor, *, num_experts: int, top_k: int = 2,
            capacity_factor: float = 1.25, activation: str = "gelu",
            activation_fp32: bool = True, dtype=None,
            aux_weight: float = 0.01, z_weight: float = 1e-3,
            rng: Optional[int] = None, dropout_rate: float = 0.0,
            valid: Optional[torch.Tensor] = None, no_drop: bool = False,
            tensor=None, expert=None, batch_group=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux fp32 scalar)
    (kosmosx_tpu/nn/moe.py:114-193). Each batch row is a routing group.

    ``valid`` (B, S) bool: pads route nowhere, take no capacity, give zero
    output and are left out of the aux losses. ``no_drop``: buffers of S
    slots, so no token is dropped and routing does not depend on padding or
    group size (the cached inference paths). ``rng``: the dropout key of
    the output.

    ``expert`` (a ``parallel.tensor.Axis``): the expert stacks hold this
    rank's ``E / ep`` experts. Every rank routes all of ``x`` alike, runs
    its experts' part of the dispatch buffer, and the ranks' outputs are
    summed (``reduce_from``); ``x`` and the router enter under ``copy_to``
    and the routing loss as a 1/ep share, so every gradient is the whole
    one. ``tensor``: the experts are cut Megatron's way (``_expert_ffn``).
    ``batch_group``: the groups a training batch is split over; the
    routing loss is then the rank's share of the global batch's
    (``_aux_loss``)."""
    if top_k > num_experts:
        raise ValueError(f"top_k {top_k} > num_experts {num_experts}")
    g, t, d = x.shape
    cap = t if no_drop else moe_capacity(t, num_experts, top_k,
                                         capacity_factor)
    x = tpar.copy_to(x, expert)
    router = tpar.copy_to(params["router"]["w"], expert)
    logits = x.float() @ router.float()                             # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    expert_id, slot, gate = _routing(probs, num_experts, top_k, cap, valid)
    aux = _aux_loss(logits, probs, expert_id[0], num_experts, aux_weight,
                    z_weight, valid, batch_group)
    local, first = num_experts, 0
    if expert is not None:
        aux = tpar.reduce_from(aux / expert.size, expert)
        local = num_experts // expert.size
        first = expert.rank * local

    cdt = dtype or x.dtype
    rows = local * g * cap             # row r = (e * G + g) * C + slot
    group = torch.arange(g, device=x.device)[:, None]
    flat = ((expert_id - first) * g + group) * cap + slot
    mine = (gate > 0) & (expert_id >= first) & (expert_id < first + local)
    flat = torch.where(mine, flat, torch.full_like(flat, rows))
    xin = x.new_zeros((rows + 1, d), dtype=cdt).index_put(
        (flat.reshape(-1),), x.to(cdt).expand(top_k, g, t, d).reshape(-1, d))
    out = _expert_ffn(params["experts"], xin[:rows].view(local, g * cap, d),
                      activation, activation_fp32, tensor)
    out = torch.cat([out.reshape(rows, d), out.new_zeros((1, d))])
    y = (out[flat].float() * gate[..., None]).sum(dim=0)
    y = tpar.reduce_from(y, expert)
    y = layers.dropout(y, dropout_rate, rng)
    return y.to(x.dtype), aux


def moe_ffn_dense_oracle(params, x: torch.Tensor, *, num_experts: int,
                         top_k: int = 2, activation: str = "gelu",
                         activation_fp32: bool = True) -> torch.Tensor:
    """Every token through each of its top-k experts, unlimited capacity,
    mixed by the router's gates (kosmosx_tpu/nn/moe.py:196-228). A test
    oracle: E full FFN passes."""
    logits = x.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gates = torch.zeros_like(probs)
    p = probs
    for _ in range(top_k):
        oh = F.one_hot(p.argmax(dim=-1), num_experts).to(probs.dtype)
        gates = gates + oh * p
        p = p * (1.0 - oh)
    ex = params["experts"]
    act = layers.activation_fn(activation)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(num_experts):
        dt = torch.promote_types(x.dtype, ex["fc1"]["w"].dtype)
        h = x.to(dt) @ ex["fc1"]["w"][e] + ex["fc1"]["b"][e]
        h = act(h.float()).to(h.dtype) if activation_fp32 else act(h)
        if "ffn_ln" in ex:
            mean = h.mean(dim=-1, keepdim=True)
            var = (h - mean).square().mean(dim=-1, keepdim=True)
            h = ((h - mean) * torch.rsqrt(var + 1e-5)
                 * ex["ffn_ln"]["scale"][e] + ex["ffn_ln"]["bias"][e])
        out = h @ ex["fc2"]["w"][e] + ex["fc2"]["b"][e]
        y = y + gates[..., e:e + 1] * out.float()
    return y.to(x.dtype)
