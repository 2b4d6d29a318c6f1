"""CLIP ViT vision tower (counterpart of kosmosx_tpu/nn/vision.py).

HF-CLIP semantics: a 14x14 stride-14 patch embedding as one matmul over
space-to-depth patches, a class token, learned positions, a pre-LayerNorm,
pre-LN encoder layers, and ``last_hidden_state`` returned without the final
post-LayerNorm. The 257-token attention is below the flash rule of
kosmosx_tpu/nn/vision.py:84 (512 tokens), so it is plain torch, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from kosmosx_torch.core import initializers as init
from kosmosx_torch.core.config import VisionConfig
from kosmosx_torch.nn import layers
from kosmosx_torch.ops.flash_attention import flash_attention

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def init_vit_layer(gen, cfg: VisionConfig, device=None):
    d, m = cfg.hidden_dim, cfg.mlp_dim

    def lin(i, o):
        return layers.init_linear(gen, i, o, device=device)

    return {
        "ln1": layers.init_layer_norm(d, device=device),
        "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
                 "out": lin(d, d)},
        "ln2": layers.init_layer_norm(d, device=device),
        "mlp": {"fc1": lin(d, m), "fc2": lin(m, d)},
    }


def init_clip_vit(gen, cfg: VisionConfig, device=None) -> Dict[str, Any]:
    """kosmosx_tpu/nn/vision.py:59-71."""
    d = cfg.hidden_dim
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    return {
        "class_embedding": init.normal(gen, (d,), std=d ** -0.5, device=device),
        "patch_embed": {"w": init.xavier_uniform(gen, (patch_dim, d),
                                                 device=device)},
        "pos_embed": {"table": init.normal(gen, (cfg.seq_len, d),
                                           std=d ** -0.5, device=device)},
        "pre_ln": layers.init_layer_norm(d, device=device),
        "layers": [init_vit_layer(gen, cfg, device) for _ in range(cfg.layers)],
        "post_ln": layers.init_layer_norm(d, device=device),
    }


def _vit_attention(params, x: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """kosmosx_tpu/nn/vision.py:74-92."""
    b, l, d = x.shape
    h, hd = cfg.heads, cfg.head_dim

    def heads(t):
        return t.reshape(b, l, h, hd).transpose(1, 2)

    q = heads(layers.linear(params["q"], x, dtype=cfg.dtype) * hd ** -0.5)
    k = heads(layers.linear(params["k"], x, dtype=cfg.dtype))
    v = heads(layers.linear(params["v"], x, dtype=cfg.dtype))
    if cfg.use_flash_attention and l >= 512:
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=False, sm_scale=1.0)
    else:
        s = q.float() @ k.float().transpose(-1, -2)
        o = torch.softmax(s, dim=-1).to(v.dtype) @ v
    o = o.transpose(1, 2).reshape(b, l, d)
    return layers.linear(params["out"], o, dtype=cfg.dtype)


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, 3, H, W) -> (B, (H/p)*(W/p), 3*p*p), (c, ph, pw) order per patch
    (kosmosx_tpu/nn/vision.py:95-103)."""
    b, c, hh, ww = pixel_values.shape
    hp, wp = hh // patch_size, ww // patch_size
    x = pixel_values.reshape(b, c, hp, patch_size, wp, patch_size)
    x = x.permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, hp * wp, c * patch_size * patch_size)


def clip_vit(params, pixel_values: torch.Tensor, cfg: VisionConfig, *,
             return_pooled: bool = False):
    """CLIP-normalised pixels (B, 3, H, W) -> last_hidden_state (B, 257, d)
    (kosmosx_tpu/nn/vision.py:106-142)."""
    dtype = cfg.dtype
    b = pixel_values.shape[0]
    patches = patchify(pixel_values.to(dtype), cfg.patch_size)
    x = layers.linear(params["patch_embed"], patches, dtype=dtype)
    cls = params["class_embedding"].to(dtype).expand(b, 1, cfg.hidden_dim)
    x = torch.cat([cls, x], dim=1)
    x = x + layers.dense_weight(params["pos_embed"]["table"], dtype)[None]
    x = layers.layer_norm(params["pre_ln"], x, eps=cfg.layer_norm_eps)
    act = layers.activation_fn(cfg.activation)
    for lp in params["layers"]:
        h = layers.layer_norm(lp["ln1"], x, eps=cfg.layer_norm_eps)
        x = x + _vit_attention(lp["attn"], h, cfg)
        h = layers.layer_norm(lp["ln2"], x, eps=cfg.layer_norm_eps)
        h = layers.linear(lp["mlp"]["fc1"], h, dtype=dtype)
        h = act(h.float()).to(dtype)
        x = x + layers.linear(lp["mlp"]["fc2"], h, dtype=dtype)
    if return_pooled:
        pooled = layers.layer_norm(params["post_ln"], x[:, 0],
                                   eps=cfg.layer_norm_eps)
        return x, pooled
    return x
