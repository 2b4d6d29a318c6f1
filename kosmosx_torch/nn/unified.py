"""Shared-trunk any-modality encoder, ImageBind-style (counterpart of
kosmosx_tpu/nn/unified.py).

Per-modality tokenizers map raw inputs to trunk tokens, each one linear:
image patches (B, 3, H, W), audio frames of ``audio_patch`` samples (B, T),
video tubes (B, 3, T, H, W), and "any" input flattened into zero-padded
audio-width frames. A learned CLS token, learned positions and a learned
per-modality embedding go in front of one shared pre-LN trunk, the ViT
layer of ``nn/vision.py``; the post-LN CLS state (B, 1, hidden) is the
joint embedding. The trunk's attention takes the non-causal flash kernel
without xPos when ``use_flash_attention`` is set and a sequence holds 512
tokens or more (``nn/vision._vit_attention``, the rule of
kosmosx_tpu/nn/vision.py:84).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from kosmosx_torch.core import initializers as init
from kosmosx_torch.core.config import resolve_dtype
from kosmosx_torch.nn import layers
from kosmosx_torch.nn.vision import _vit_attention, init_vit_layer, patchify

MODALITIES = ("image", "audio", "video", "any")


@dataclasses.dataclass(frozen=True)
class UnifiedConfig:
    """Shared-trunk encoder config (kosmosx_tpu/nn/unified.py:33-58); the
    attribute names are ``VisionConfig``'s where ``nn/vision``'s layer
    functions read them."""

    hidden_dim: int = 512
    layers: int = 6
    heads: int = 8
    mlp_dim: int = 2048
    layer_norm_eps: float = 1e-5
    activation: str = "gelu"
    compute_dtype: str = "float32"
    use_flash_attention: bool = False
    max_tokens: int = 512
    image_patch: int = 14
    audio_patch: int = 400
    video_tube_t: int = 2
    video_tube_hw: int = 16

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.heads

    @property
    def dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)


def init_unified_encoder(gen, cfg: UnifiedConfig,
                         device=None) -> Dict[str, Any]:
    """kosmosx_tpu/nn/unified.py:61-80."""
    d = cfg.hidden_dim
    return {
        "cls": init.normal(gen, (d,), std=d ** -0.5, device=device),
        "pos": {"table": init.normal(gen, (cfg.max_tokens, d), std=d ** -0.5,
                                     device=device)},
        "modality_embed": {"table": init.normal(
            gen, (len(MODALITIES), d), std=d ** -0.5, device=device)},
        "tok_image": {"w": init.xavier_uniform(
            gen, (3 * cfg.image_patch ** 2, d), device=device)},
        "tok_audio": {"w": init.xavier_uniform(gen, (cfg.audio_patch, d),
                                               device=device)},
        "tok_video": {"w": init.xavier_uniform(
            gen, (3 * cfg.video_tube_t * cfg.video_tube_hw ** 2, d),
            device=device)},
        "pre_ln": layers.init_layer_norm(d, device=device),
        "post_ln": layers.init_layer_norm(d, device=device),
        "layers": [init_vit_layer(gen, cfg, device) for _ in range(cfg.layers)],
    }


def _tokenize(params, x: torch.Tensor, modality: str,
              cfg: UnifiedConfig) -> torch.Tensor:
    """Raw input -> (B, N, hidden) trunk tokens (kosmosx_tpu/nn/unified.py:
    83-121); raises where an input makes zero tokens."""
    dtype = cfg.dtype
    if modality == "image":
        patches = patchify(x.to(dtype), cfg.image_patch)
        return layers.linear(params["tok_image"], patches, dtype=dtype)
    if modality == "audio":
        b, t = x.shape
        n = t // cfg.audio_patch
        if n == 0:
            raise ValueError(
                f"audio length {t} is shorter than one patch "
                f"(audio_patch={cfg.audio_patch}); the trunk would see zero "
                f"input tokens")
        frames = x[:, :n * cfg.audio_patch].to(dtype).reshape(
            b, n, cfg.audio_patch)
        return layers.linear(params["tok_audio"], frames, dtype=dtype)
    if modality == "video":
        b, c, t, hh, ww = x.shape
        tt, p = cfg.video_tube_t, cfg.video_tube_hw
        nt, nh, nw = t // tt, hh // p, ww // p
        if nt == 0 or nh == 0 or nw == 0:
            raise ValueError(
                f"video shape (t={t}, h={hh}, w={ww}) smaller than one tube "
                f"(t={tt}, hw={p}); the trunk would see zero input tokens")
        tubes = x.to(dtype).reshape(b, c, nt, tt, nh, p, nw, p)
        tubes = tubes.permute(0, 2, 4, 6, 1, 3, 5, 7)  # (B,nt,nh,nw,c,tt,p,p)
        tubes = tubes.reshape(b, nt * nh * nw, c * tt * p * p)
        return layers.linear(params["tok_video"], tubes, dtype=dtype)
    # "any": trailing dims flattened into zero-padded audio-width frames
    b = x.shape[0]
    flat = x.to(dtype).reshape(b, -1)
    n = max(1, -(-flat.shape[1] // cfg.audio_patch))
    frames = F.pad(flat, (0, n * cfg.audio_patch - flat.shape[1]))
    return layers.linear(params["tok_audio"],
                         frames.reshape(b, n, cfg.audio_patch), dtype=dtype)


def unified_encode(params, x: torch.Tensor, modality: str,
                   cfg: UnifiedConfig) -> torch.Tensor:
    """One modality through the shared trunk -> (B, 1, hidden), the post-LN
    CLS embedding (kosmosx_tpu/nn/unified.py:124-153)."""
    if modality not in MODALITIES:
        raise ValueError(f"unknown modality {modality!r}")
    dtype = cfg.dtype
    tokens = _tokenize(params, x, modality, cfg)
    b, n, d = tokens.shape
    if n + 1 > cfg.max_tokens:
        raise ValueError(f"{n + 1} tokens exceed max_tokens={cfg.max_tokens}")
    cls = params["cls"].to(dtype).expand(b, 1, d)
    x = torch.cat([cls, tokens], dim=1)
    x = x + layers.dense_weight(params["pos"]["table"], dtype)[None, :n + 1]
    x = x + layers.dense_weight(params["modality_embed"]["table"],
                                dtype)[MODALITIES.index(modality)]
    x = layers.layer_norm(params["pre_ln"], x, eps=cfg.layer_norm_eps)
    act = layers.activation_fn(cfg.activation)
    for lp in params["layers"]:
        h = layers.layer_norm(lp["ln1"], x, eps=cfg.layer_norm_eps)
        x = x + _vit_attention(lp["attn"], h, cfg)
        h = layers.layer_norm(lp["ln2"], x, eps=cfg.layer_norm_eps)
        h = act(layers.linear(lp["mlp"]["fc1"], h, dtype=dtype).float())
        x = x + layers.linear(lp["mlp"]["fc2"], h.to(dtype), dtype=dtype)
    return layers.layer_norm(params["post_ln"], x[:, :1],
                             eps=cfg.layer_norm_eps)
