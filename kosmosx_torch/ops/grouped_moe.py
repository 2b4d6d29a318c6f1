"""A dropless mixture of experts with grouped products: routing, the
permutation by expert, the expert SwiGLU over a data-dependent number of
tokens an expert, and the gated combine (the LFM2 MoE, ``nn/lfm2.py``).

The JAX package's MoE (``nn/moe.py`` here too) gives each expert a fixed
number of capacity slots, drops what overflows and pads the rest, so every
expert's product has one shape. This one drops nothing: every token goes
to its ``top_k`` experts, and the products run over the experts' actual
token counts. Nothing in it reads the device from the host:

- ``route``: fp32 router logits, ``s = sigmoid``, the experts chosen by
  ``topk(s + expert_bias)``, the gates ``s`` at the chosen experts
  normalised to sum 1 (``+ 1e-6``) times the scaling factor; then the
  token copies sorted by expert (a stable sort, so a token's copies keep
  their order within an expert), each expert's count and the running end
  offsets as device tensors, and the rows of x gathered in that order.
- ``expert_ffn``: ``w2(silu(w1 x) * w3 x)`` of every expert over its rows
  of the permuted x, as two grouped products (``w1`` and ``w3`` as one
  (E, D, 2 F) stack) over the device offsets: ``torch._grouped_mm`` on the
  card, a loop over the experts on the CPU.
- ``combine``: ``res + sum_k gate_k * y[pos_k]`` in fp32, one rounding to
  the residual's dtype: the kernel ``kx_moe_combine`` of ``csrc/lfm2.cu``
  on the card (the fp32 residual stream and bf16 experts' rows, the
  residual added in the same pass), plain torch on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from kosmosx_torch.utils import trace


@dataclasses.dataclass
class Routing:
    """One MoE layer's routing of T tokens to ``top_k`` of E experts:
    ``experts`` and ``gates`` (T, top_k), int64 and fp32; ``pos`` (T,
    top_k) int32, the row of each token's choice among the copies sorted
    by expert; ``counts`` (E,) and ``offsets`` (E,) int32, the rows of
    each expert and their running end; ``x`` (T top_k, D) the tokens' rows
    in that order."""

    experts: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor
    x: torch.Tensor


def router_gates(x: torch.Tensor, router_w: torch.Tensor,
                 expert_bias: Optional[torch.Tensor], top_k: int,
                 scaling: float = 1.0):
    """(experts, gates) of each token: fp32 logits ``x @ router_w``,
    ``s = sigmoid``, experts ``topk(s + expert_bias)``, gates ``s`` there
    over their sum (+ 1e-6), times ``scaling``."""
    s = torch.sigmoid(x.float() @ router_w.float())
    choose = s if expert_bias is None else s + expert_bias.float()
    experts = torch.topk(choose, top_k, dim=-1).indices
    gates = torch.gather(s, 1, experts)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-6) * scaling
    return experts, gates


def route(x: torch.Tensor, router_w: torch.Tensor,
          expert_bias: Optional[torch.Tensor], top_k: int,
          scaling: float = 1.0) -> Routing:
    """Route x (T, D) and permute its copies by expert, inside a
    ``moe.route`` span; every count and offset stays on x's device."""
    n_exp = router_w.shape[-1]
    with trace.span("moe.route", device=True) as sp:
        if sp.on:
            sp.set(tokens=x.shape[0], experts=n_exp, top_k=top_k)
        experts, gates = router_gates(x, router_w, expert_bias, top_k,
                                      scaling)
        flat = experts.reshape(-1)
        order = torch.argsort(flat, stable=True)
        pos = torch.empty_like(order)
        pos[order] = torch.arange(order.numel(), device=x.device)
        counts = torch.zeros(n_exp, dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat))
        offsets = counts.cumsum(0).to(torch.int32)
        xs = x.index_select(0, order // top_k)
        return Routing(experts, gates, pos.view(-1, top_k).to(torch.int32),
                       counts.to(torch.int32), offsets, xs)


def _grouped(a: torch.Tensor, w: torch.Tensor, routing: Routing):
    """The per-expert products ``a[rows of e] @ w[e]`` over the routing's
    offsets: one grouped product on the card, a loop on the CPU."""
    if a.device.type == "cuda":
        return torch._grouped_mm(a, w, offs=routing.offsets)
    out = a.new_empty((a.shape[0], w.shape[-1]))
    start = 0
    for e, end in enumerate(routing.offsets.tolist()):
        out[start:end] = a[start:end] @ w[e]
        start = end
    return out


def expert_ffn(routing: Routing, w13: torch.Tensor,
               w2: torch.Tensor) -> torch.Tensor:
    """Every expert's ``w2(silu(w1 x) * w3 x)`` on its rows of the permuted
    x, in x's dtype: ``w13`` (E, D, 2 F) holds ``w1`` and ``w3`` side by
    side, ``w2`` (E, F, D). Inside an ``op.moe_experts`` span, which
    carries the experts' row counts (a device tensor, read once the
    records are) while tracing is on."""
    x = routing.x
    ffn = w2.shape[1]
    with trace.span("op.moe_experts", device=True) as sp:
        if sp.on:
            sp.set(assignments=x.shape[0], experts=w13.shape[0],
                   d=x.shape[1], ffn=ffn, itemsize=x.element_size(),
                   counts=routing.counts.clone())
        h = _grouped(x, w13.to(x.dtype), routing)
        act = F.silu(h[:, :ffn]) * h[:, ffn:]
        return _grouped(act, w2.to(x.dtype), routing)


def combine_plain(res: torch.Tensor, y: torch.Tensor, pos: torch.Tensor,
                  gates: torch.Tensor) -> torch.Tensor:
    """``res + sum_k gates[:, k] * y[pos[:, k]]`` in fp32, in res's
    dtype."""
    picked = y.float()[pos.long()]                   # (T, top_k, D)
    mixed = (gates[..., None] * picked).sum(dim=1)
    return (res.float() + mixed).to(res.dtype)


def combine(res: torch.Tensor, y: torch.Tensor, routing: Routing
            ) -> torch.Tensor:
    """The experts' outputs gated back onto their tokens, plus the
    residual ``res`` (T, D): the kernel inside a ``moe.combine`` span on a
    CUDA tensor, ``combine_plain`` on a CPU one."""
    pos, gates = routing.pos, routing.gates
    if res.device.type == "cpu":
        return combine_plain(res, y, pos, gates)
    if (res.dtype, y.dtype) != (torch.float32, torch.bfloat16):
        raise TypeError(f"the combine kernel takes an fp32 res and bf16 y; "
                        f"got {res.dtype}, {y.dtype}")
    t, d = res.shape
    if d % 8 or not res.is_contiguous() or not y.is_contiguous() \
            or res.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("the combine kernel takes contiguous, 16-byte "
                         "aligned rows a multiple of 8 wide")
    from kosmosx_torch.ops import _build

    top_k = pos.shape[1]
    with trace.span("moe.combine", device=True) as sp:
        if sp.on:
            sp.set(tokens=t, experts=int(routing.counts.shape[0]),
                   top_k=top_k)
        out = torch.empty_like(res)
        if t:
            pos32 = pos.contiguous()
            gates32 = gates.float().contiguous()
            lib = _build.library()
            err = lib.kx_moe_combine(
                res.data_ptr(), y.data_ptr(), pos32.data_ptr(),
                gates32.data_ptr(), out.data_ptr(), t, d, top_k,
                torch.cuda.current_stream(res.device).cuda_stream)
            _build.check(lib, err, "kx_moe_combine launch")
            combine.launches += 1
        return out


# kernel launches on CUDA tensors (plain-version calls are not counted)
combine.launches = 0
