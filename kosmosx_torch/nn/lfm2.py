"""The LFM2 hybrid decoder (``lfm2_moe``): gated short-convolution layers
and GQA attention layers, a dense SwiGLU FFN in the first layers and a
dropless sigmoid-routed MoE in the rest, RMSNorm throughout and a head
tied to the embedding (``core.config.Lfm2Config``).

The JAX package has no counterpart: this is the port's own model code, over
the port's kernels (``ops/short_conv``, ``ops/qk_rope``, the flash forward
with grouped key/value heads, ``ops/layer_norm.rms_norm``,
``ops/grouped_moe``). Every kernel wrapper takes its plain version for CPU
tensors, so the same code runs the CPU tests.

The parameter tree (``init_lfm2``; weights ``(in, out)``, applied as ``x @
w``; D the hidden size, F the dense and Fe the expert width, E experts):

- ``embed.table`` (V, D), also the head (``tie_embedding``); ``norm.scale``
  (D), the final RMSNorm;
- ``layers.i.operator_norm.scale``, ``layers.i.ffn_norm.scale`` (D);
- a conv layer: ``conv.in_proj.w`` (D, 3 D), its columns B, C, x~ in that
  order; ``conv.taps`` (D, 3), tap 2 on the position itself;
  ``conv.out_proj.w`` (D, D);
- an attention layer: ``attn.qkv.w`` (D, (H + 2 Hkv) 64), columns q heads,
  k heads, v heads; ``attn.q_norm.scale``, ``attn.k_norm.scale`` (64);
  ``attn.out.w`` (H 64, D);
- a dense layer: ``ffn.w13.w`` (D, 2 F), ``w1`` then ``w3``; ``ffn.w2.w``
  (F, D);
- an expert layer: ``moe.router.w`` (D, E); ``moe.expert_bias`` (E,), kept
  in fp32 whatever the weights' dtype; ``moe.w13`` (E, D, 2 Fe) and
  ``moe.w2`` (E, Fe, D), the experts stacked.

The hidden state, the residual stream, is (B L, D) in fp32 from the
embedding to the head: each layer reads it through RMSNorm into the
compute dtype and adds its mixer's and its FFN's outputs to it in fp32
(the experts' in the combine kernel). A bf16 stream is rounded 80 times a
forward: at 4 x 8,192 tokens on an H100 it moved the logits 4.3% (rms,
against the fp32 reference) where the fp32 stream moves them 2.5%, for
3.8% of the forward's time; the rest of the gap is mostly tokens whose
expert choice flips between near-equal router scores.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from kosmosx_torch.core import initializers as init
from kosmosx_torch.core.config import Lfm2Config
from kosmosx_torch.ops import flash_attention as fa
from kosmosx_torch.ops import grouped_moe as gm
from kosmosx_torch.ops import layer_norm as ln
from kosmosx_torch.ops import qk_rope
from kosmosx_torch.ops import short_conv as sc
from kosmosx_torch.utils import trace


def _proj(gen, shape, device):
    """A projection of fan-in ``shape[-2]``: N(0, fan_in**-0.5)."""
    return init.normal(gen, shape, std=shape[-2] ** -0.5, device=device)


def init_lfm2(gen: torch.Generator, cfg: Lfm2Config,
              device=None) -> Dict[str, Any]:
    """A seeded fp32 parameter tree: projections N(0, fan_in**-0.5), the
    embedding N(0, D**-0.5), norms 1, conv taps uniform in +-3**-0.5 (a
    depthwise Conv1d's default), expert bias 0."""
    cfg.check_supported()
    d, hd = cfg.hidden_size, cfg.head_dim
    h, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    e, fe = cfg.num_experts, cfg.moe_intermediate_size

    def scale(n):
        return {"scale": init.ones((n,), device)}

    layers = []
    for i, kind in enumerate(cfg.layer_types):
        layer: Dict[str, Any] = {"operator_norm": scale(d),
                                 "ffn_norm": scale(d)}
        if kind == "conv":
            bound = 1.0 / math.sqrt(sc.TAPS)
            taps = torch.rand((d, sc.TAPS), generator=gen,
                              device=device).mul_(2 * bound).sub_(bound)
            layer["conv"] = {"in_proj": {"w": _proj(gen, (d, 3 * d), device)},
                             "taps": taps,
                             "out_proj": {"w": _proj(gen, (d, d), device)}}
        else:
            layer["attn"] = {
                "qkv": {"w": _proj(gen, (d, (h + 2 * hkv) * hd), device)},
                "q_norm": scale(hd), "k_norm": scale(hd),
                "out": {"w": _proj(gen, (h * hd, d), device)}}
        if i < cfg.num_dense_layers:
            f = cfg.intermediate_size
            layer["ffn"] = {"w13": {"w": _proj(gen, (d, 2 * f), device)},
                            "w2": {"w": _proj(gen, (f, d), device)}}
        else:
            layer["moe"] = {"router": {"w": _proj(gen, (d, e), device)},
                            "expert_bias": init.zeros((e,), device),
                            "w13": _proj(gen, (e, d, 2 * fe), device),
                            "w2": _proj(gen, (e, fe, d), device)}
        layers.append(layer)
    return {"embed": {"table": init.embedding_init(
                gen, (cfg.vocab_size, d), device)},
            "layers": layers, "norm": scale(d)}


def _w(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


def conv_mixer(p, x: torch.Tensor, res: torch.Tensor, seq_len: int,
               dtype: torch.dtype) -> torch.Tensor:
    """``res + out_proj(C * conv(B * x~))``, B, C, x~ from ``in_proj(x)``."""
    bcx = x @ _w(p["in_proj"]["w"], dtype)
    y = sc.short_conv(bcx, _w(p["taps"], dtype), seq_len)
    return res + y @ _w(p["out_proj"]["w"], dtype)


def attn_mixer(p, x: torch.Tensor, res: torch.Tensor, batch: int,
               cfg: Lfm2Config) -> torch.Tensor:
    """``res + out(attention)``: q, k, v from one projection, q and k
    RMS-normed per head and rotated (``qk_rope``), causal softmax
    attention with each key/value head read by H / Hkv query heads (the
    flash forward), the heads joined and projected."""
    dt = cfg.dtype
    qkv = x @ _w(p["qkv"]["w"], dt)
    q, k, v = qk_rope.qk_norm_rope(
        qkv, p["q_norm"]["scale"], p["k_norm"]["scale"], batch=batch,
        heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
        theta=cfg.rope_theta, eps=cfg.norm_eps)
    o = fa.flash_attention_fwd(q, k, v, causal=True,
                               sm_scale=cfg.head_dim ** -0.5)[0]
    o = o.transpose(1, 2).reshape(x.shape[0], -1)
    return res + o @ _w(p["out"]["w"], dt)


def dense_ffn(p, x: torch.Tensor, res: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``res + w2(silu(w1 x) * w3 x)``."""
    h = x @ _w(p["w13"]["w"], dtype)
    f = h.shape[1] // 2
    return res + (F.silu(h[:, :f]) * h[:, f:]) @ _w(p["w2"]["w"], dtype)


def moe_ffn(p, x: torch.Tensor, res: torch.Tensor,
            cfg: Lfm2Config) -> torch.Tensor:
    """``res + sum_k gate_k expert_k(x)``: every token on its
    ``num_experts_per_tok`` experts, none dropped (``ops/grouped_moe``)."""
    routing = gm.route(x, p["router"]["w"], p["expert_bias"],
                       cfg.num_experts_per_tok, cfg.routed_scaling_factor)
    y = gm.expert_ffn(routing, p["w13"], p["w2"])
    return gm.combine(res, y, routing)


def layer_forward(p, x: torch.Tensor, cfg: Lfm2Config, kind: str,
                  batch: int) -> torch.Tensor:
    """One layer on the (B L, D) fp32 hidden state."""
    dt, eps = cfg.dtype, cfg.norm_eps
    xn = ln.rms_norm(x, p["operator_norm"]["scale"], eps=eps, out_dtype=dt)
    if kind == "conv":
        h = conv_mixer(p["conv"], xn, x, x.shape[0] // batch, dt)
    else:
        h = attn_mixer(p["attn"], xn, x, batch, cfg)
    hn = ln.rms_norm(h, p["ffn_norm"]["scale"], eps=eps, out_dtype=dt)
    if "ffn" in p:
        return dense_ffn(p["ffn"], hn, h, dt)
    return moe_ffn(p["moe"], hn, h, cfg)


def decoder(params, tokens: torch.Tensor, cfg: Lfm2Config) -> torch.Tensor:
    """The embedding and every layer: the fp32 hidden state (B L, D)
    before the final norm."""
    b = tokens.shape[0]
    x = F.embedding(tokens.reshape(-1), params["embed"]["table"]).float()
    for layer, kind in zip(params["layers"], cfg.layer_types):
        x = layer_forward(layer, x, cfg, kind, b)
    return x


def head(params, x: torch.Tensor, cfg: Lfm2Config) -> torch.Tensor:
    """The final RMSNorm and the tied head: logits (B L, V) in the compute
    dtype."""
    h = ln.rms_norm(x, params["norm"]["scale"], eps=cfg.norm_eps,
                    out_dtype=cfg.dtype)
    return h @ _w(params["embed"]["table"], cfg.dtype).t()


def forward(params, tokens: torch.Tensor, cfg: Lfm2Config) -> torch.Tensor:
    """tokens (B, L), one sequence a row -> logits (B, L, V), inside the
    ``model.decoder`` and ``model.head`` spans."""
    b, l = tokens.shape
    with trace.span("model.decoder", device=True) as sp:
        if sp.on:
            sp.set(shape=[b, l])
        x = decoder(params, tokens, cfg)
    with trace.span("model.head", device=True):
        return head(params, x, cfg).view(b, l, -1)
