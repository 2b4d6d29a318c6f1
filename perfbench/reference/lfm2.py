"""A plain float32 reference of LFM2-24B-A2B (``lfm2_moe``), for the
benchmark's correctness check.

It follows the published model (LiquidAI/LFM2-24B-A2B ``config.json`` and
the ``lfm2_moe`` layer equations):

- a layer is ``h = x + mixer(operator_norm(x))``, ``out = h +
  ffn(ffn_norm(h))``; after the last, ``embedding_norm``, then the head,
  which is the embedding table (``tie_embedding``);
- RMSNorm: ``w * x / sqrt(mean(x^2) + eps)``;
- conv mixer: ``B, C, x~ = split3(in_proj(x))``, ``y = C * conv(B * x~)``
  with a causal depthwise ``conv1d`` of 3 taps (zero before the row's
  first position), no bias, then ``out_proj``;
- attention mixer: ``q = RMSNorm_64(Wq x)``, ``k = RMSNorm_64(Wk x)``, ``v
  = Wv x``; RoPE (rotate-half, theta 1e6, positions 0..L-1 of each row) on
  q and k; causal softmax attention at scale 64**-0.5, key/value head ``h
  // 4`` for query head ``h``; ``out_proj``;
- FFN: SwiGLU ``w2(silu(w1 x) * w3 x)``, dense in the first
  ``num_dense_layers`` layers; else 64 experts behind a router: ``s =
  sigmoid(x Wr)``, the experts ``topk(s + expert_bias, 4)``, the gates
  ``s`` there over their sum + 1e-6, times ``routed_scaling_factor``, every
  token on its 4 experts (no capacity, no drops).

Departures: none in the equations. Everything runs in float32 from the
benchmark's bfloat16 weights (upcast a layer at a time, an expert at a
time) with TF32 off, where the published model runs in bfloat16; the fused
leaves of ``perfbench/weights_lfm2.py`` (q, k and v as one ``qkv``
projection, ``w1`` and ``w3`` as one ``w13``) are split here. To fit on the
card beside the weights and the program's kept logits: the layers run over
the whole batch, attention in blocks of query rows, the experts one at a
time, and the head one row at a time (``row_logits``).

It imports nothing of the program under test. ``Lin`` takes the precision
of the linear products: ``"fp32"`` (the reference) or ``"fp8"`` (every
product's operands rounded to e4m3 under per-tensor scales, float32
accumulation: the control of a bfloat16 configuration).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.kosmos import _per_tensor, strict_fp32

__all__ = ["strict_fp32", "Lin", "param_specs", "hidden", "row_logits",
           "logprobs"]

PRECISIONS = ("fp32", "fp8")
HEAD_DIM = 64
QUERY_BLOCK = 512          # query rows of an attention block
EXPERT_BIAS_STD = 0.1      # the assumed expert bias: N(0, 0.1), fp32
TOKEN_BLOCK = 8192         # rows of a dense-FFN block


class Lin:
    """The linear product ``x @ w`` at one precision (float32 operands)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return _per_tensor(x, "e4m3") @ _per_tensor(w, "e4m3")
        return x @ w


# ---------------------------------------------------------------------------
# the parameter tree: dotted paths, shapes and initial distributions
# ---------------------------------------------------------------------------


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str, tuple]]:
    """``(path, shape, kind, arg)`` of every parameter, in the program's
    layout (``kosmosx_torch/nn/lfm2.py``): ``kind`` ``"normal"`` (std
    ``arg[0]``) or ``"uniform"`` (in ``[arg[0], arg[1]]``). The
    distributions are the configuration's ``assumed`` ones, chosen so that
    the random model is not chaotic: bf16 rounding then moves the logits
    by a few percent, as it moves a trained model's, and not by their own
    size. The table is N(0, 1), so the embedding carries the residual
    stream; projections are N(0, fan_in**-0.5), and those that end a
    residual branch (the conv's and the attention's ``out_proj``, the FFN's
    and the experts' ``w2``) that over ``sqrt(2 * layers)`` (GPT-2's
    scaled initialisation), so each layer moves the stream by about a
    tenth; conv taps uniform in +-3**-0.5; RMSNorm weights uniform in
    [0.9, 1.1], the per-head q and k norms in [1.5, 2.5] (scores spread as
    a trained model's do), the final norm's [0.9, 1.1] / sqrt(D) (logits
    of about unit spread from the N(0, 1) tied head); the expert bias
    N(0, ``EXPERT_BIAS_STD``), which moves a share of each token's choices
    against plain top-k of the router's sigmoids (they spread over about
    0.2)."""
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    e, fe, f = (cfg["num_experts"], cfg["moe_intermediate_size"],
                cfg["intermediate_size"])
    taps = cfg["conv_L_cache"]
    norm = ("uniform", (0.9, 1.1))
    qk_norm = ("uniform", (1.5, 2.5))
    branch_end = (2.0 * len(cfg["layer_types"])) ** -0.5

    def proj(path, shape, gain=1.0):
        return (path, shape, "normal", (gain * shape[-2] ** -0.5,))

    specs = [("embed.table", (cfg["vocab_size"], d), "normal", (1.0,))]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layers.{i}"
        specs += [(f"{p}.operator_norm.scale", (d,)) + norm,
                  (f"{p}.ffn_norm.scale", (d,)) + norm]
        if kind == "conv":
            b = 1.0 / math.sqrt(taps)
            specs += [proj(f"{p}.conv.in_proj.w", (d, 3 * d)),
                      (f"{p}.conv.taps", (d, taps), "uniform", (-b, b)),
                      proj(f"{p}.conv.out_proj.w", (d, d), branch_end)]
        else:
            specs += [proj(f"{p}.attn.qkv.w", (d, (h + 2 * hkv) * HEAD_DIM)),
                      (f"{p}.attn.q_norm.scale", (HEAD_DIM,)) + qk_norm,
                      (f"{p}.attn.k_norm.scale", (HEAD_DIM,)) + qk_norm,
                      proj(f"{p}.attn.out.w", (h * HEAD_DIM, d), branch_end)]
        if i < cfg["num_dense_layers"]:
            specs += [proj(f"{p}.ffn.w13.w", (d, 2 * f)),
                      proj(f"{p}.ffn.w2.w", (f, d), branch_end)]
        else:
            specs += [proj(f"{p}.moe.router.w", (d, e)),
                      (f"{p}.moe.expert_bias", (e,), "normal",
                       (EXPERT_BIAS_STD,)),
                      proj(f"{p}.moe.w13", (e, d, 2 * fe)),
                      proj(f"{p}.moe.w2", (e, fe, d), branch_end)]
    specs.append(("norm.scale", (d,), "uniform", (0.9 * d ** -0.5,
                                                   1.1 * d ** -0.5)))
    return specs


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{dotted path: tensor}`` as nested dicts, ``layers`` a list."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        parts = path.split(".")
        for key, nxt in zip(parts[:-1], parts[1:]):
            if key == "layers":
                node = node.setdefault("layers", [])
                continue
            if isinstance(node, list):
                i = int(key)
                while len(node) <= i:
                    node.append({})
                node = node[i]
                continue
            node = node.setdefault(key, {})
        node[parts[-1]] = t
    return out


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE in rotate-half form on (..., L, 64), positions 0..L-1."""
    length = x.shape[-2]
    inv = 1.0 / (theta ** (torch.arange(0, HEAD_DIM, 2, dtype=torch.int64,
                                        device=x.device).float() / HEAD_DIM))
    ang = torch.arange(length, device=x.device, dtype=torch.float32)[:, None] \
        * inv[None, :]
    cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
    half = HEAD_DIM // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def _f(flat, path: str) -> torch.Tensor:
    return flat[path].float()


def conv_mixer(flat, p: str, x: torch.Tensor, lin: Lin) -> torch.Tensor:
    b, length, d = x.shape
    bcx = lin(x, _f(flat, f"{p}.in_proj.w"))
    bg, cg, xt = bcx.split(d, dim=-1)
    taps = _f(flat, f"{p}.taps")
    bx = (bg * xt).transpose(1, 2)
    conv = F.conv1d(bx, taps[:, None, :], groups=d,
                    padding=taps.shape[1] - 1)[..., :length]
    return lin(cg * conv.transpose(1, 2), _f(flat, f"{p}.out_proj.w"))


def attn_mixer(flat, p: str, x: torch.Tensor, cfg: dict,
               lin: Lin) -> torch.Tensor:
    b, length, d = x.shape
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    eps, theta = cfg["norm_eps"], float(cfg["rope_parameters"]["rope_theta"])
    qkv = lin(x, _f(flat, f"{p}.qkv.w"))
    q, k, v = qkv.split([h * HEAD_DIM, hkv * HEAD_DIM, hkv * HEAD_DIM], -1)
    q = rms_norm(q.view(b, length, h, HEAD_DIM),
                 _f(flat, f"{p}.q_norm.scale"), eps).transpose(1, 2)
    k = rms_norm(k.view(b, length, hkv, HEAD_DIM),
                 _f(flat, f"{p}.k_norm.scale"), eps).transpose(1, 2)
    v = v.view(b, length, hkv, HEAD_DIM).transpose(1, 2)
    q, k = rope(q, theta), rope(k, theta)
    k = k.repeat_interleave(h // hkv, dim=1)
    v = v.repeat_interleave(h // hkv, dim=1)
    o = torch.empty_like(q)
    scale = HEAD_DIM ** -0.5
    for q0 in range(0, length, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, length)
        s = (q[:, :, q0:q1] @ k[:, :, :q1].transpose(-1, -2)) * scale
        rows = torch.arange(q0, q1, device=x.device)[:, None]
        cols = torch.arange(q1, device=x.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        o[:, :, q0:q1] = torch.softmax(s, dim=-1) @ v[:, :, :q1]
        del s
    o = o.transpose(1, 2).reshape(b, length, h * HEAD_DIM)
    return lin(o, _f(flat, f"{p}.out.w"))


def swiglu(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor,
           lin: Lin) -> torch.Tensor:
    f = w13.shape[-1] // 2
    return lin(F.silu(lin(x, w13[:, :f])) * lin(x, w13[:, f:]), w2)


def dense_ffn(flat, p: str, x: torch.Tensor, lin: Lin) -> torch.Tensor:
    w13, w2 = _f(flat, f"{p}.w13.w"), _f(flat, f"{p}.w2.w")
    flat_x = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(flat_x)
    for t0 in range(0, flat_x.shape[0], TOKEN_BLOCK):
        out[t0:t0 + TOKEN_BLOCK] = swiglu(flat_x[t0:t0 + TOKEN_BLOCK], w13,
                                          w2, lin)
    return out.view(x.shape)


def route(flat, p: str, x: torch.Tensor, cfg: dict, lin: Lin):
    """(experts, gates) (T, top_k) of the rows of x (T, D)."""
    s = torch.sigmoid(lin(x, _f(flat, f"{p}.router.w")))
    experts = torch.topk(s + _f(flat, f"{p}.expert_bias"),
                         cfg["num_experts_per_tok"], dim=-1).indices
    gates = torch.gather(s, 1, experts)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-6)
    return experts, gates * cfg["routed_scaling_factor"]


def moe_ffn(flat, p: str, x: torch.Tensor, cfg: dict,
            lin: Lin) -> torch.Tensor:
    flat_x = x.reshape(-1, x.shape[-1])
    experts, gates = route(flat, p, flat_x, cfg, lin)
    out = torch.zeros_like(flat_x)
    w13, w2 = flat[f"{p}.w13"], flat[f"{p}.w2"]
    for e in range(w13.shape[0]):
        rows, slot = (experts == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(flat_x[rows], w13[e].float(), w2[e].float(), lin)
        out.index_add_(0, rows, y * gates[rows, slot][:, None])
    return out.view(x.shape)


def hidden(flat: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
           lin: Lin) -> torch.Tensor:
    """The hidden state (B, L, D) after the last layer, before the final
    norm, of tokens (B, L), one sequence a row."""
    eps = cfg["norm_eps"]
    x = flat["embed.table"][tokens].float()
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layers.{i}"
        xn = rms_norm(x, _f(flat, f"{p}.operator_norm.scale"), eps)
        if kind == "conv":
            h = x + conv_mixer(flat, f"{p}.conv", xn, lin)
        else:
            h = x + attn_mixer(flat, f"{p}.attn", xn, cfg, lin)
        del xn
        hn = rms_norm(h, _f(flat, f"{p}.ffn_norm.scale"), eps)
        if i < cfg["num_dense_layers"]:
            x = h + dense_ffn(flat, f"{p}.ffn", hn, lin)
        else:
            x = h + moe_ffn(flat, f"{p}.moe", hn, cfg, lin)
        del h, hn
    return x


def row_logits(flat: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
               lin: Lin) -> torch.Tensor:
    """One row's logits (L, V) from its hidden state (L, D): the final
    norm and the tied head."""
    h = rms_norm(x, _f(flat, "norm.scale"), cfg["norm_eps"])
    return lin(h, flat["embed.table"].float().t())


def logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Log-probabilities (L - 1,) of each next token of a row from its
    logits (L, V)."""
    logp = torch.log_softmax(logits[:-1].float(), dim=-1)
    return torch.gather(logp, -1, tokens[1:, None].long())[:, 0]
