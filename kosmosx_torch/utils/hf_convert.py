"""HF CLIP vision checkpoints -> the port's vision parameters (counterpart of
the CLIP part of kosmosx_tpu/utils/hf_convert.py:23-116).

The reference downloads ``laion/CLIP-ViT-L-14-laion2B-s32B-b82K`` when it
builds its model; here a local HF ``CLIPVisionModel`` (or its state dict,
or its ``model.safetensors`` / ``pytorch_model.bin`` file) converts once to
the tree that ``nn/vision.py`` runs and ``Kosmos(params=...)`` takes under
``clip``, every leaf a contiguous fp32 tensor. Conventions: a torch
``nn.Linear.weight`` (out, in) becomes ``w`` (in, out); the patch
convolution's (d, 3, p, p) weight becomes a flat (3 * p * p, d) ``w`` in
``nn/vision.patchify``'s (c, ph, pw) order.

The wav2vec2, data2vec and r3d18 converters come with the modality zoo
(ROADMAP Queue 1 item 9b).
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


def clip_vision_params_from_hf(model_or_state_dict, device=None
                               ) -> Dict[str, Any]:
    """HF ``CLIPVisionModel`` / ``CLIPModel.vision_model`` or its state dict
    -> the vision tree (kosmosx_tpu/utils/hf_convert.py:41-86). Keys may
    carry the ``vision_model.`` prefix."""
    sd = (model_or_state_dict if isinstance(model_or_state_dict, dict)
          else model_or_state_dict.state_dict())
    if any(k.startswith("vision_model.") for k in sd):
        sd = {k[len("vision_model."):]: v for k, v in sd.items()
              if k.startswith("vision_model.")}
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
