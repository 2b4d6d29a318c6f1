"""Audio tower (counterpart of kosmosx_tpu/nn/audio.py): raw waveform (B, T)
-> frame features (B, T', hidden_dim), which the composition models
mean-pool and project to the decoder width.

``arch="framed"``: stride == kernel framing stages as reshapes and matmuls
(static strides 8, 4, 2), erf-gelu, an input projection, a LayerNorm, then
pre-LN layers of plain non-causal attention without xPos (the decoder's
``self_attention`` with ``use_flash=False``, as JAX calls it).
``arch="wav2vec2"``: the HF encoder of ``nn/wav2vec2.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from kosmosx_torch.core import initializers as init
from kosmosx_torch.core.config import AudioConfig
from kosmosx_torch.nn import layers
from kosmosx_torch.nn.attention import self_attention
from kosmosx_torch.nn.wav2vec2 import init_wav2vec2, wav2vec2_encode


def frame_strides(cfg: AudioConfig):
    """Per-stage framing strides, config and not parameters
    (kosmosx_tpu/nn/audio.py:29-40)."""
    strides = (8, 4, 2)
    if len(cfg.conv_widths) > len(strides):
        raise ValueError(
            f"conv_widths has {len(cfg.conv_widths)} stages but only "
            f"{len(strides)} framing strides are defined; extra stages "
            f"would be silently dropped")
    return strides[:len(cfg.conv_widths)]


def init_audio_encoder(gen, cfg: AudioConfig, device=None) -> Dict[str, Any]:
    """kosmosx_tpu/nn/audio.py:43-83."""
    if cfg.arch == "wav2vec2":
        if cfg.hidden_dim != cfg.w2v.hidden_dim:
            raise ValueError(
                f"arch='wav2vec2': AudioConfig.hidden_dim "
                f"({cfg.hidden_dim}) must equal w2v.hidden_dim "
                f"({cfg.w2v.hidden_dim}) — the composition layer projects "
                f"from hidden_dim")
        return init_wav2vec2(gen, cfg.w2v, device)
    convs = []
    in_ch = 1
    for width, stride in zip(cfg.conv_widths, frame_strides(cfg)):
        convs.append({"w": init.xavier_uniform(gen, (in_ch * stride, width),
                                               device=device),
                      "b": init.zeros((width,), device)})
        in_ch = width
    d = cfg.hidden_dim

    def lin(i, o):
        return layers.init_linear(gen, i, o, device=device)

    enc_layers = [{
        "ln1": layers.init_layer_norm(d, device=device),
        "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
                 "out": lin(d, d)},
        "ln2": layers.init_layer_norm(d, device=device),
        "mlp": {"fc1": lin(d, cfg.mlp_dim), "fc2": lin(cfg.mlp_dim, d)},
    } for _ in range(cfg.layers)]
    return {
        "convs": convs,
        "in_proj": lin(in_ch, d),
        "ln": layers.init_layer_norm(d, device=device),
        "layers": enc_layers,
    }


def audio_encoder(params, waveform: torch.Tensor,
                  cfg: AudioConfig) -> torch.Tensor:
    """waveform (B, T) -> (B, T', hidden_dim) (kosmosx_tpu/nn/audio.py:
    86-114); the framed tower drops the samples past the last whole frame
    of each stage."""
    if cfg.arch == "wav2vec2":
        return wav2vec2_encode(params, waveform, cfg.w2v)
    dtype = cfg.dtype
    x = waveform.to(dtype)[..., None]  # (B, T, 1)
    for conv, stride in zip(params["convs"], frame_strides(cfg)):
        b, t, c = x.shape
        t = (t // stride) * stride
        x = x[:, :t].reshape(b, t // stride, c * stride)
        x = F.gelu(layers.linear(conv, x, dtype=dtype).float()).to(dtype)
    x = layers.linear(params["in_proj"], x, dtype=dtype)
    x = layers.layer_norm(params["ln"], x)
    for lp in params["layers"]:
        h = layers.layer_norm(lp["ln1"], x)
        x = x + self_attention(lp["attn"], h, heads=cfg.heads, subln=False,
                               multiway=False, causal=False, xpos=False,
                               use_flash=False, dtype=dtype)
        h = layers.layer_norm(lp["ln2"], x)
        h = F.gelu(layers.linear(lp["mlp"]["fc1"], h, dtype=dtype).float())
        x = x + layers.linear(lp["mlp"]["fc2"], h.to(dtype), dtype=dtype)
    return x
