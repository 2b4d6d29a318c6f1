"""Flamingo PerceiverResampler (counterpart of kosmosx_tpu/nn/resampler.py).

Learned latents cross-attend to the media tokens concatenated with the
latents themselves; a per-media-slot position embedding; per depth step an
attention block and a bias-free GELU feed-forward, both residual; a final
LayerNorm. The cross-attention is plain torch, as in JAX
(kosmosx_tpu/nn/resampler.py:69-93).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from kosmosx_torch.core import initializers as init
from kosmosx_torch.core.config import ResamplerConfig
from kosmosx_torch.nn import layers


def init_resampler(gen, cfg: ResamplerConfig, device=None) -> Dict[str, Any]:
    """kosmosx_tpu/nn/resampler.py:36-66."""
    d, inner = cfg.dim, cfg.inner_dim

    def w(i, o):
        return {"w": init.xavier_uniform(gen, (i, o), device=device)}

    def attn_block():
        return {"norm_media": layers.init_layer_norm(d, device=device),
                "norm_latents": layers.init_layer_norm(d, device=device),
                "to_q": w(d, inner), "to_kv": w(d, 2 * inner),
                "to_out": w(inner, d)}

    def ff_block():
        return {"norm": layers.init_layer_norm(d, device=device),
                "fc1": w(d, cfg.ff_mult * d), "fc2": w(cfg.ff_mult * d, d)}

    return {
        "latents": init.normal(gen, (cfg.num_latents, d), device=device),
        "media_pos_emb": init.normal(gen, (cfg.num_media_embeds, d),
                                     device=device),
        "layers": [{"attn": attn_block(), "ff": ff_block()}
                   for _ in range(cfg.depth)],
        "norm": layers.init_layer_norm(d, device=device),
    }


def _perceiver_attention(params, media, latents, cfg: ResamplerConfig):
    """media (B, M, N, d); latents (B, M, L, d) -> (B, M, L, d)."""
    dtype = cfg.dtype
    x = layers.layer_norm(params["norm_media"], media)
    lat = layers.layer_norm(params["norm_latents"], latents)
    h, hd = cfg.heads, cfg.dim_head
    q = layers.linear(params["to_q"], lat, dtype=dtype)
    kv = layers.linear(params["to_kv"], torch.cat([x, lat], dim=-2),
                       dtype=dtype)
    k, v = kv.chunk(2, dim=-1)

    def heads(t):
        b, m, n, _ = t.shape
        return t.reshape(b, m, n, h, hd).transpose(2, 3)  # (B, M, H, N, hd)

    q, k, v = heads(q) * hd ** -0.5, heads(k), heads(v)
    s = q.float() @ k.float().transpose(-1, -2)
    s = s - s.amax(dim=-1, keepdim=True)
    o = torch.softmax(s, dim=-1).to(v.dtype) @ v
    b, m = o.shape[:2]
    o = o.transpose(2, 3).reshape(b, m, -1, h * hd)
    return layers.linear(params["to_out"], o, dtype=dtype)


def resampler(params, media: torch.Tensor, cfg: ResamplerConfig) -> torch.Tensor:
    """media (B, N, d) or (B, M, N, d) -> latents (B, M, num_latents, d)
    (kosmosx_tpu/nn/resampler.py:96-113)."""
    dtype = cfg.dtype
    if media.ndim == 3:
        media = media[:, None]
    b, m = media.shape[:2]
    media = media.to(dtype) + params["media_pos_emb"][:m, None].to(dtype)
    latents = params["latents"].to(dtype).expand(b, m, cfg.num_latents, cfg.dim)
    for lp in params["layers"]:
        latents = latents + _perceiver_attention(lp["attn"], media, latents, cfg)
        ff = lp["ff"]
        hh = layers.layer_norm(ff["norm"], latents)
        hh = layers.linear(ff["fc1"], hh, dtype=dtype)
        hh = F.gelu(hh.float()).to(dtype)
        latents = latents + layers.linear(ff["fc2"], hh, dtype=dtype)
    return layers.layer_norm(params["norm"], latents)
