"""The HF wav2vec2 / data2vec-audio encoder (counterpart of
kosmosx_tpu/nn/wav2vec2.py), eval mode, weight for weight with
``Wav2Vec2Model`` / ``Data2VecAudioModel`` so their checkpoints convert one
to one (``utils/hf_convert.py``):

- feature extractor: VALID strided 1-D convs, erf-gelu after each; "group"
  norm mode normalises conv 0's output per channel over time, "layer" mode
  every conv's over channels;
- feature projection: LayerNorm, then a linear to the hidden width;
- positional conv: one grouped conv ("wav2vec2") or ``pos_convs`` stacked
  grouped convs each followed by an affine-less LayerNorm and gelu
  ("data2vec"); an even kernel drops its last output column;
- post-LN layers (base, data2vec) or pre-LN ("stable", large).

Layout: the tree keeps JAX's shapes, conv kernels WIO ``(k, cin/groups,
cout)``, so the carry-over from JAX stays a copy by path; each conv permutes
its kernel to torch's ``(cout, cin/groups, k)`` at the call and runs on
(B, C, T), cuDNN's layout. Between convs activations are (B, T, C), as in
JAX, where the norms and linears work over the channel axis. The
convolutions are library calls (``F.conv1d``), as JAX's are XLA
convolutions outside any Pallas kernel. Attention forms its scores in the
compute dtype and casts them to fp32 before the softmax (the order of
kosmosx_tpu/nn/wav2vec2.py:128, unlike the vision tower's).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from kosmosx_torch.core import initializers as init
from kosmosx_torch.core.config import Wav2Vec2Config
from kosmosx_torch.nn import layers


def _conv1d(w, b, x: torch.Tensor, stride: int, *, padding: int = 0,
            groups: int = 1, dtype=None) -> torch.Tensor:
    """x (B, T, Cin), w (k, Cin/groups, Cout) -> (B, T', Cout)."""
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    out = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride,
                   padding=padding, groups=groups).transpose(1, 2)
    if b is not None:
        out = out + (b.to(dtype) if dtype is not None else b)
    return out


def _channel_norm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """GroupNorm with groups == channels: per-(B, C) normalisation over
    time, in x's dtype (kosmosx_tpu/nn/wav2vec2.py:54-61). x (B, T, C)."""
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _gelu(x: torch.Tensor, dtype) -> torch.Tensor:
    return F.gelu(x.float()).to(dtype)


def init_wav2vec2(gen, cfg: Wav2Vec2Config, device=None) -> Dict[str, Any]:
    """Random init in the converter's tree layout
    (kosmosx_tpu/nn/wav2vec2.py:64-114)."""
    convs: List[Dict[str, Any]] = []
    cin = 1
    for i, (cdim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        p: Dict[str, Any] = {"w": init.xavier_uniform(gen, (k, cin, cdim),
                                                      device=device)}
        if cfg.conv_bias:
            p["b"] = init.zeros((cdim,), device)
        if cfg.feat_norm == "layer" or (cfg.feat_norm == "group" and i == 0):
            p["norm"] = layers.init_layer_norm(cdim, device=device)
        convs.append(p)
        cin = cdim
    d = cfg.hidden_dim
    n_pos = cfg.pos_convs if cfg.pos_conv_mode == "data2vec" else 1
    pos = [{"w": init.xavier_uniform(
        gen, (cfg.pos_conv_kernel, d // cfg.pos_conv_groups, d),
        device=device), "b": init.zeros((d,), device)} for _ in range(n_pos)]

    def lin(i, o):
        return layers.init_linear(gen, i, o, device=device)

    enc_layers = [{
        "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
                 "out": lin(d, d)},
        "ln1": layers.init_layer_norm(d, device=device),
        "mlp": {"fc1": lin(d, cfg.mlp_dim), "fc2": lin(cfg.mlp_dim, d)},
        "ln2": layers.init_layer_norm(d, device=device),
    } for _ in range(cfg.layers)]
    return {
        "convs": convs,
        "feat_proj": {"ln": layers.init_layer_norm(cfg.conv_dim[-1],
                                                   device=device),
                      **lin(cfg.conv_dim[-1], d)},
        "pos_conv": pos,
        "enc_ln": layers.init_layer_norm(d, device=device),
        "layers": enc_layers,
    }


def _attention(p, x: torch.Tensor, heads: int, dtype) -> torch.Tensor:
    """kosmosx_tpu/nn/wav2vec2.py:117-132."""
    b, t, d = x.shape
    hd = d // heads

    def split(z):
        return z.reshape(b, t, heads, hd).transpose(1, 2)

    q = split(layers.linear(p["q"], x, dtype=dtype) * hd ** -0.5)
    k = split(layers.linear(p["k"], x, dtype=dtype))
    v = split(layers.linear(p["v"], x, dtype=dtype))
    s = (q @ k.transpose(-1, -2)).float()
    o = torch.softmax(s, dim=-1).to(q.dtype) @ v
    o = o.transpose(1, 2).reshape(b, t, d)
    return layers.linear(p["out"], o, dtype=dtype)


def _mlp(p, x: torch.Tensor, dtype) -> torch.Tensor:
    h = _gelu(layers.linear(p["fc1"], x, dtype=dtype), dtype)
    return layers.linear(p["fc2"], h, dtype=dtype)


def wav2vec2_encode(params, waveform: torch.Tensor,
                    cfg: Wav2Vec2Config) -> torch.Tensor:
    """waveform (B, T) -> contextual features (B, T', hidden_dim): HF's
    ``last_hidden_state`` in eval mode with the whole input valid
    (kosmosx_tpu/nn/wav2vec2.py:135-205)."""
    dtype = cfg.dtype
    eps = cfg.layer_norm_eps
    x = waveform.to(dtype)[..., None]  # (B, T, 1)
    for i, (p, stride) in enumerate(zip(params["convs"], cfg.conv_stride)):
        x = _conv1d(p["w"], p["b"] if "b" in p else None, x, stride,
                    dtype=dtype)
        if cfg.feat_norm == "group" and i == 0:
            x = _channel_norm(x, p["norm"]["scale"], p["norm"]["bias"], eps)
        elif cfg.feat_norm == "layer":
            x = layers.layer_norm(p["norm"], x, eps=eps)
        x = _gelu(x, dtype)

    fp = params["feat_proj"]
    x = layers.layer_norm(fp["ln"], x, eps=eps)
    x = layers.linear(fp, x, dtype=dtype)

    pk = cfg.pos_conv_kernel
    h = x
    for p in params["pos_conv"]:
        h = _conv1d(p["w"], p["b"], h, 1, padding=pk // 2,
                    groups=cfg.pos_conv_groups, dtype=dtype)
        if pk % 2 == 0:
            h = h[:, :-1]
        if cfg.pos_conv_mode != "wav2vec2":  # data2vec: affine-less LN
            mean = h.mean(dim=-1, keepdim=True)
            var = (h - mean).square().mean(dim=-1, keepdim=True)
            h = (h - mean) * torch.rsqrt(var + eps)
        h = _gelu(h, dtype)
    x = x + h

    if not cfg.stable_layer_norm:
        x = layers.layer_norm(params["enc_ln"], x, eps=eps)
    for lp in params["layers"]:
        if cfg.stable_layer_norm:  # pre-LN (wav2vec2-large)
            x = x + _attention(lp["attn"],
                               layers.layer_norm(lp["ln1"], x, eps=eps),
                               cfg.heads, dtype)
            x = x + _mlp(lp["mlp"], layers.layer_norm(lp["ln2"], x, eps=eps),
                         dtype)
        else:  # post-LN (wav2vec2-base, data2vec-audio)
            x = layers.layer_norm(
                lp["ln1"], x + _attention(lp["attn"], x, cfg.heads, dtype),
                eps=eps)
            x = layers.layer_norm(lp["ln2"], x + _mlp(lp["mlp"], x, dtype),
                                  eps=eps)
    if cfg.stable_layer_norm:
        x = layers.layer_norm(params["enc_ln"], x, eps=eps)
    return x
