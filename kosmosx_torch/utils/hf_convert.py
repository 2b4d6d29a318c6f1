"""HF and torchvision checkpoints -> the port's parameter trees (counterpart
of kosmosx_tpu/utils/hf_convert.py).

The reference downloads ``laion/CLIP-ViT-L-14-laion2B-s32B-b82K`` when it
builds its model; here a local HF ``CLIPVisionModel`` (or its state dict,
or its ``model.safetensors`` / ``pytorch_model.bin`` file) converts once to
the tree that ``nn/vision.py`` runs and ``Kosmos(params=...)`` takes under
``clip``, every leaf a contiguous fp32 tensor. Conventions: a torch
``nn.Linear.weight`` (out, in) becomes ``w`` (in, out); the patch
convolution's (d, 3, p, p) weight becomes a flat (3 * p * p, d) ``w`` in
``nn/vision.patchify``'s (c, ph, pw) order.

The audio and video towers (kosmosx_tpu/utils/hf_convert.py:119-264): an
HF ``Wav2Vec2Model`` or ``Data2VecAudioModel`` (or its state dict) to the
``nn/wav2vec2.py`` tree, the positional conv's weight norm folded into a
plain kernel; torchvision's ``r3d_18`` state dict to the ``nn/video.py``
``arch="r3d18"`` tree, each eval-mode BatchNorm folded into the bias-free
conv before it. Conv kernels take JAX's layouts: a Conv1d's (out, in/g, k)
becomes WIO (k, in/g, out), a Conv3d's (out, in, kt, kh, kw) DHWIO (kt, kh,
kw, in, out).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch


def as_f32(x, device=None) -> torch.Tensor:
    """A torch tensor or an array-like as a contiguous fp32 tensor on
    ``device`` (default: the tensor's own, or the CPU)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.detach().to(device=device, dtype=torch.float32).contiguous()


def linear_in(sd: Dict[str, Any], prefix: str, device=None) -> Dict[str, Any]:
    out = {"w": as_f32(sd[f"{prefix}.weight"], device).T.contiguous()}
    if f"{prefix}.bias" in sd:
        out["b"] = as_f32(sd[f"{prefix}.bias"], device)
    return out


def ln_in(sd: Dict[str, Any], prefix: str, device=None) -> Dict[str, Any]:
    return {"scale": as_f32(sd[f"{prefix}.weight"], device),
            "bias": as_f32(sd[f"{prefix}.bias"], device)}


def _state_dict(model_or_state_dict) -> Dict[str, Any]:
    if hasattr(model_or_state_dict, "state_dict"):
        return model_or_state_dict.state_dict()
    return model_or_state_dict


def _strip(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """Keys under ``prefix`` without it, where any key has it (the
    ``*ForCTC`` wrappers), else ``sd``."""
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
    return sd


def clip_vision_params_from_hf(model_or_state_dict, device=None
                               ) -> Dict[str, Any]:
    """HF ``CLIPVisionModel`` / ``CLIPModel.vision_model`` or its state dict
    -> the vision tree (kosmosx_tpu/utils/hf_convert.py:41-86). Keys may
    carry the ``vision_model.`` prefix."""
    sd = _strip(_state_dict(model_or_state_dict), "vision_model.")
    pe = as_f32(sd["embeddings.patch_embedding.weight"], device)  # (d,3,p,p)
    layers = []
    i = 0
    while f"encoder.layers.{i}.layer_norm1.weight" in sd:
        p = f"encoder.layers.{i}"
        layers.append({
            "ln1": ln_in(sd, f"{p}.layer_norm1", device),
            "attn": {n: linear_in(sd, f"{p}.self_attn.{n}_proj", device)
                     for n in ("q", "k", "v", "out")},
            "ln2": ln_in(sd, f"{p}.layer_norm2", device),
            "mlp": {"fc1": linear_in(sd, f"{p}.mlp.fc1", device),
                    "fc2": linear_in(sd, f"{p}.mlp.fc2", device)},
        })
        i += 1
    return {
        "class_embedding": as_f32(sd["embeddings.class_embedding"], device),
        "patch_embed": {"w": pe.reshape(pe.shape[0], -1).T.contiguous()},
        "pos_embed": {"table": as_f32(
            sd["embeddings.position_embedding.weight"], device)},
        "pre_ln": ln_in(sd, "pre_layrnorm", device),
        "layers": layers,
        "post_ln": ln_in(sd, "post_layernorm", device),
    }


def load_clip_checkpoint(path: str, device=None) -> Dict[str, Any]:
    """A local HF CLIP checkpoint (``model.safetensors``, a torch
    ``pytorch_model.bin``, or a directory holding one) -> the vision tree
    (kosmosx_tpu/utils/hf_convert.py:89-116). ``safetensors`` is imported
    only for a ``.safetensors`` file; a full ``CLIPModel`` file's
    ``text_model.*`` keys are ignored."""
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"{path}: no model.safetensors / pytorch_model.bin")
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"{path}: reading a .safetensors file needs the "
                              f"safetensors package") from e
        sd: Dict[str, Any] = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return clip_vision_params_from_hf(sd, device)


def _conv1d_w(sd: Dict[str, Any], prefix: str, device=None) -> torch.Tensor:
    """torch Conv1d weight (out, in/groups, k) -> WIO (k, in/groups, out)."""
    return as_f32(sd[f"{prefix}.weight"], device).permute(2, 1, 0).contiguous()


def _pos_conv_weight(sd: Dict[str, Any], prefix: str,
                     device=None) -> torch.Tensor:
    """The weight-normed (dim=2) positional conv folded to ``g * v /
    ||v||`` (kosmosx_tpu/utils/hf_convert.py:124-136), under the
    ``parametrizations.weight.original0/1`` names or the older
    ``weight_g``/``weight_v``; a plain weight as it is."""
    for g_key, v_key in ((f"{prefix}.parametrizations.weight.original0",
                          f"{prefix}.parametrizations.weight.original1"),
                         (f"{prefix}.weight_g", f"{prefix}.weight_v")):
        if g_key in sd:
            g, v = as_f32(sd[g_key], device), as_f32(sd[v_key], device)
            norm = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
            return (g * v / norm).permute(2, 1, 0).contiguous()
    return _conv1d_w(sd, prefix, device)


def wav2vec2_params_from_hf(model_or_state_dict, feat_norm: str = "group",
                            device=None) -> Dict[str, Any]:
    """HF ``Wav2Vec2Model`` (or its state dict, keys optionally under
    ``wav2vec2.``) -> the ``nn/wav2vec2.py`` tree
    (kosmosx_tpu/utils/hf_convert.py:138-201). ``feat_norm``: "group" for
    base checkpoints, "layer" for large / stable-layer-norm ones; it must
    match the model's config."""
    sd = _strip(_state_dict(model_or_state_dict), "wav2vec2.")
    convs = []
    i = 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in sd:
        p = f"feature_extractor.conv_layers.{i}"
        c: Dict[str, Any] = {"w": _conv1d_w(sd, f"{p}.conv", device)}
        if f"{p}.conv.bias" in sd:
            c["b"] = as_f32(sd[f"{p}.conv.bias"], device)
        if f"{p}.layer_norm.weight" in sd:  # GroupNorm (conv 0) or LayerNorm
            c["norm"] = ln_in(sd, f"{p}.layer_norm", device)
        convs.append(c)
        i += 1
    if feat_norm == "group" and "norm" not in convs[0]:
        raise KeyError("feat_norm='group' but conv 0 has no norm weights")

    params: Dict[str, Any] = {
        "convs": convs,
        "feat_proj": {"ln": ln_in(sd, "feature_projection.layer_norm", device),
                      **linear_in(sd, "feature_projection.projection", device)},
        "enc_ln": ln_in(sd, "encoder.layer_norm", device),
    }
    conv = "encoder.pos_conv_embed.conv"
    if any(k.startswith(f"{conv}.") for k in sd):
        params["pos_conv"] = [{"w": _pos_conv_weight(sd, conv, device),
                               "b": as_f32(sd[f"{conv}.bias"], device)}]
    else:  # data2vec: stacked plain convs
        pos = []
        i = 0
        while f"encoder.pos_conv_embed.layers.{i}.conv.weight" in sd:
            p = f"encoder.pos_conv_embed.layers.{i}.conv"
            pos.append({"w": _conv1d_w(sd, p, device),
                        "b": as_f32(sd[f"{p}.bias"], device)})
            i += 1
        params["pos_conv"] = pos

    enc_layers = []
    i = 0
    while f"encoder.layers.{i}.layer_norm.weight" in sd:
        p = f"encoder.layers.{i}"
        enc_layers.append({
            "attn": {n: linear_in(sd, f"{p}.attention.{n}_proj", device)
                     for n in ("q", "k", "v", "out")},
            "ln1": ln_in(sd, f"{p}.layer_norm", device),
            "mlp": {"fc1": linear_in(
                sd, f"{p}.feed_forward.intermediate_dense", device),
                    "fc2": linear_in(sd, f"{p}.feed_forward.output_dense",
                                     device)},
            "ln2": ln_in(sd, f"{p}.final_layer_norm", device),
        })
        i += 1
    params["layers"] = enc_layers
    return params


def data2vec_audio_params_from_hf(model_or_state_dict,
                                  device=None) -> Dict[str, Any]:
    """HF ``Data2VecAudioModel`` (or its state dict, keys optionally under
    ``data2vec_audio.``) -> the ``nn/wav2vec2.py`` tree, for
    ``Wav2Vec2Config(feat_norm="layer", pos_conv_mode="data2vec")``
    (kosmosx_tpu/utils/hf_convert.py:204-214)."""
    sd = _strip(_state_dict(model_or_state_dict), "data2vec_audio.")
    return wav2vec2_params_from_hf(sd, feat_norm="layer", device=device)


def _fold_bn_into_conv3d(sd: Dict[str, Any], conv: str, bn: str,
                         eps: float = 1e-5, device=None) -> Dict[str, Any]:
    """An eval-mode BatchNorm3d after a Conv3d folded into it: the kernel
    scaled per output channel by ``gamma / sqrt(var + eps)``, the bias
    ``beta - mean * scale`` (plus the conv's own bias, scaled)
    (kosmosx_tpu/utils/hf_convert.py:221-236)."""
    w = as_f32(sd[f"{conv}.weight"], device)
    gamma, beta = as_f32(sd[f"{bn}.weight"], device), as_f32(sd[f"{bn}.bias"],
                                                             device)
    mean = as_f32(sd[f"{bn}.running_mean"], device)
    var = as_f32(sd[f"{bn}.running_var"], device)
    scale = gamma / torch.sqrt(var + eps)
    b = beta - mean * scale
    if f"{conv}.bias" in sd:
        b = b + as_f32(sd[f"{conv}.bias"], device) * scale
    w = w * scale[:, None, None, None, None]
    return {"w": w.permute(2, 3, 4, 1, 0).contiguous(), "b": b.contiguous()}


def r3d18_params_from_state_dict(model_or_state_dict,
                                 device=None) -> Dict[str, Any]:
    """torchvision ``r3d_18`` (or its state dict) -> the ``nn/video.py``
    ``arch="r3d18"`` tree, BatchNorms folded, the ``fc`` head left out
    (kosmosx_tpu/utils/hf_convert.py:239-264)."""
    sd = _state_dict(model_or_state_dict)

    def fold(conv, bn):
        return _fold_bn_into_conv3d(sd, conv, bn, device=device)

    stages = []
    for s in range(1, 5):
        blocks = []
        for b in range(2):
            p = f"layer{s}.{b}"
            blocks.append({
                "conv1": fold(f"{p}.conv1.0", f"{p}.conv1.1"),
                "conv2": fold(f"{p}.conv2.0", f"{p}.conv2.1"),
                "down": (fold(f"{p}.downsample.0", f"{p}.downsample.1")
                         if f"{p}.downsample.0.weight" in sd else None),
            })
        stages.append(blocks)
    return {"stem": fold("stem.0", "stem.1"), "stages": stages}
