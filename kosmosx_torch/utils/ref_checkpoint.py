"""The reference's torch ``state_dict`` <-> the port's parameter trees
(counterpart of kosmosx_tpu/utils/ref_checkpoint.py:59-360).

The reference saves its trained model as one consolidated ``state_dict``,
``checkpoints/final/final_model.pt``. Its modules: ``clip_model.*`` (an HF
CLIPVisionTransformer), ``embed``, ``embed_positions`` and
``output_projection`` at the top level (the torchscale decoder registers
them again as ``decoder.embed_tokens`` / ``decoder.embed_positions`` /
``decoder.output_projection``), ``decoder.*`` (torchscale: multiway wraps
each sub-module into ``.A`` / ``.B`` copies, sub-LN adds
``self_attn.inner_attn_ln`` and ``ffn.ffn_layernorm``), ``perceive.*``
(flamingo-pytorch's PerceiverResampler, ``media_pos_emb`` stored (M, 1,
dim)) and ``image_proj``. The module-by-module layout is in the JAX
counterpart's docstring.

Conventions: a torch ``nn.Linear.weight`` (out, in) is the port's ``w``
(in, out); LayerNorm ``weight``/``bias`` are ``scale``/``bias``. Imported
leaves are contiguous fp32 tensors; exported values are fp32 tensors on the
parameters' device. The port's layers are a list whatever
``scan_layers`` says, so JAX's ``stack_layers``/``unstack_layers`` have no
counterpart.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from kosmosx_torch.core.config import KosmosConfig, MagnetoConfig, ResamplerConfig
from kosmosx_torch.core.params import to_tree
from kosmosx_torch.utils.hf_convert import (as_f32, clip_vision_params_from_hf,
                                            linear_in, ln_in)

# wrapper prefixes of torch.compile, DDP and FSDP (kosmosx_tpu/utils/
# ref_checkpoint.py:207-210)
_WRAPPER_PREFIXES = ("_orig_mod.", "module.", "_fsdp_wrapped_module.")


def _sub(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _mw_in(sd, prefix, leaf_fn, multiway: bool):
    if multiway:
        return {"A": leaf_fn(sd, f"{prefix}.A"), "B": leaf_fn(sd, f"{prefix}.B")}
    return leaf_fn(sd, prefix)


def _ffn_in(sd, prefix) -> Dict[str, Any]:
    out = {"fc1": linear_in(sd, f"{prefix}.fc1"),
           "fc2": linear_in(sd, f"{prefix}.fc2")}
    if f"{prefix}.ffn_layernorm.weight" in sd:
        out["ffn_ln"] = ln_in(sd, f"{prefix}.ffn_layernorm")
    return out


# ---------------------------------------------------------------------------
# import: reference state_dict -> parameter tree
# ---------------------------------------------------------------------------

def decoder_params_from_state_dict(sd: Dict[str, Any], cfg: MagnetoConfig,
                                   prefix: str = "decoder.") -> Dict[str, Any]:
    """torchscale decoder keys -> the ``nn.decoder.init_decoder`` tree
    (kosmosx_tpu/utils/ref_checkpoint.py:98-153); the embeddings and output
    projection from their top-level names or the decoder's aliases."""
    mw = cfg.multiway
    layers: List[Dict[str, Any]] = []
    i = 0
    while any(k.startswith(f"{prefix}layers.{i}.") for k in sd):
        p = f"{prefix}layers.{i}"
        attn: Dict[str, Any] = {
            n: _mw_in(sd, f"{p}.self_attn.{n}_proj", linear_in, mw)
            for n in ("q", "k", "v", "out")}
        if cfg.subln:
            attn["inner_ln"] = _mw_in(sd, f"{p}.self_attn.inner_attn_ln",
                                      ln_in, mw)
        layers.append({
            "attn": attn,
            "attn_ln": _mw_in(sd, f"{p}.self_attn_layer_norm", ln_in, mw),
            "ffn": _mw_in(sd, f"{p}.ffn", _ffn_in, mw),
            "final_ln": _mw_in(sd, f"{p}.final_layer_norm", ln_in, mw),
        })
        i += 1
    if i != cfg.layers:
        raise ValueError(f"checkpoint has {i} decoder layers, config expects "
                         f"{cfg.layers}")

    def pick(*names):
        for n in names:
            if n in sd:
                return as_f32(sd[n])
        raise KeyError(f"none of {names} in state_dict")

    return {
        "layers": layers,
        "ln": _mw_in(sd, f"{prefix}layer_norm", ln_in, mw),
        "embed": {"table": pick("embed.weight", f"{prefix}embed_tokens.weight")},
        "pos": {"table": pick("embed_positions.weight",
                              f"{prefix}embed_positions.weight")},
        "out_proj": {"w": pick("output_projection.weight",
                               f"{prefix}output_projection.weight"
                               ).T.contiguous()},
    }


def resampler_params_from_state_dict(sd: Dict[str, Any], cfg: ResamplerConfig,
                                     prefix: str = "perceive.") -> Dict[str, Any]:
    """flamingo-pytorch PerceiverResampler keys -> the ``init_resampler``
    tree (kosmosx_tpu/utils/ref_checkpoint.py:156-190); ``media_pos_emb``
    loses its middle axis."""
    media_pos = as_f32(sd[f"{prefix}media_pos_emb"])
    if media_pos.ndim == 3:
        media_pos = media_pos[:, 0].contiguous()

    def w(key):
        return as_f32(sd[key]).T.contiguous()

    layers = []
    for i in range(cfg.depth):
        a, f = f"{prefix}layers.{i}.0", f"{prefix}layers.{i}.1"
        layers.append({
            "attn": {"norm_media": ln_in(sd, f"{a}.norm_media"),
                     "norm_latents": ln_in(sd, f"{a}.norm_latents"),
                     "to_q": {"w": w(f"{a}.to_q.weight")},
                     "to_kv": {"w": w(f"{a}.to_kv.weight")},
                     "to_out": {"w": w(f"{a}.to_out.weight")}},
            # flamingo's FeedForward: Sequential(LN, Linear, GELU, Linear)
            "ff": {"norm": ln_in(sd, f"{f}.0"),
                   "fc1": {"w": w(f"{f}.1.weight")},
                   "fc2": {"w": w(f"{f}.3.weight")}},
        })
    return {"latents": as_f32(sd[f"{prefix}latents"]),
            "media_pos_emb": media_pos, "layers": layers,
            "norm": ln_in(sd, f"{prefix}norm")}


def strip_wrapper_prefixes(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A saved ``{"model": state_dict}`` unwrapped, and the prefixes of
    torch.compile, DDP and FSDP removed (kosmosx_tpu/utils/
    ref_checkpoint.py:201-210)."""
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    for junk in _WRAPPER_PREFIXES:
        if any(k.startswith(junk) for k in sd):
            sd = {k.replace(junk, ""): v for k, v in sd.items()}
    return sd


def kosmos_params_from_state_dict(sd: Dict[str, Any],
                                  cfg: KosmosConfig) -> Dict[str, Any]:
    """A reference ``final_model.pt`` state dict -> the ``Kosmos`` tree
    (kosmosx_tpu/utils/ref_checkpoint.py:193-198), on the state dict's
    device."""
    return {
        "clip": clip_vision_params_from_hf(_sub(sd, "clip_model.")),
        "resampler": resampler_params_from_state_dict(sd, cfg.resampler),
        "image_proj": {"w": as_f32(sd["image_proj.weight"]).T.contiguous()},
        "decoder": decoder_params_from_state_dict(sd, cfg.decoder),
    }


def load_reference_checkpoint(path: str, cfg: KosmosConfig) -> Dict[str, Any]:
    """The reference's consolidated ``final_model.pt`` -> the ``Kosmos``
    tree on the CPU (kosmosx_tpu/utils/ref_checkpoint.py:201-212)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return kosmos_params_from_state_dict(strip_wrapper_prefixes(sd), cfg)


# ---------------------------------------------------------------------------
# export: parameter tree -> reference state_dict
# ---------------------------------------------------------------------------

def _tree(params) -> Any:
    """A parameter-tree module's nested dicts and lists, or ``params``."""
    if isinstance(params, torch.nn.Module):
        return to_tree(params)
    return params


def _f32(x) -> torch.Tensor:
    return x.detach().float()


def _linear_out(out, prefix, p):
    out[f"{prefix}.weight"] = _f32(p["w"]).T
    if "b" in p:
        out[f"{prefix}.bias"] = _f32(p["b"])


def _ln_out(out, prefix, p):
    out[f"{prefix}.weight"] = _f32(p["scale"])
    if "bias" in p:
        out[f"{prefix}.bias"] = _f32(p["bias"])


def _mw_out(out, prefix, p, leaf_fn):
    if "A" in p and "B" in p:
        leaf_fn(out, f"{prefix}.A", p["A"])
        leaf_fn(out, f"{prefix}.B", p["B"])
    else:
        leaf_fn(out, prefix, p)


def _ffn_out(out, prefix, p):
    _linear_out(out, f"{prefix}.fc1", p["fc1"])
    _linear_out(out, f"{prefix}.fc2", p["fc2"])
    if "ffn_ln" in p:
        _ln_out(out, f"{prefix}.ffn_layernorm", p["ffn_ln"])


def state_dict_from_decoder_params(params, prefix: str = "decoder.",
                                   aliases: bool = True
                                   ) -> Dict[str, torch.Tensor]:
    """The decoder tree -> torchscale keys (kosmosx_tpu/utils/
    ref_checkpoint.py:250-292). ``aliases`` also writes the decoder's
    registered copies of the embeddings and output projection, which the
    reference's own save holds."""
    params = _tree(params)
    out: Dict[str, torch.Tensor] = {}
    for i, lp in enumerate(params["layers"]):
        p = f"{prefix}layers.{i}"
        for n in ("q", "k", "v", "out"):
            _mw_out(out, f"{p}.self_attn.{n}_proj", lp["attn"][n], _linear_out)
        if "inner_ln" in lp["attn"]:
            _mw_out(out, f"{p}.self_attn.inner_attn_ln",
                    lp["attn"]["inner_ln"], _ln_out)
        _mw_out(out, f"{p}.self_attn_layer_norm", lp["attn_ln"], _ln_out)
        _mw_out(out, f"{p}.ffn", lp["ffn"], _ffn_out)
        _mw_out(out, f"{p}.final_layer_norm", lp["final_ln"], _ln_out)
    _mw_out(out, f"{prefix}layer_norm", params["ln"], _ln_out)
    if "embed" in params:
        out["embed.weight"] = _f32(params["embed"]["table"])
        out["embed_positions.weight"] = _f32(params["pos"]["table"])
        out["output_projection.weight"] = _f32(params["out_proj"]["w"]).T
        if aliases:
            for short, long in (("embed", "embed_tokens"),
                                ("embed_positions", "embed_positions"),
                                ("output_projection", "output_projection")):
                out[f"{prefix}{long}.weight"] = out[f"{short}.weight"]
    return out


def state_dict_from_resampler_params(params, prefix: str = "perceive."
                                     ) -> Dict[str, torch.Tensor]:
    params = _tree(params)
    out: Dict[str, torch.Tensor] = {
        f"{prefix}latents": _f32(params["latents"]),
        f"{prefix}media_pos_emb": _f32(params["media_pos_emb"])[:, None]}
    for i, lp in enumerate(params["layers"]):
        a, f = f"{prefix}layers.{i}.0", f"{prefix}layers.{i}.1"
        _ln_out(out, f"{a}.norm_media", lp["attn"]["norm_media"])
        _ln_out(out, f"{a}.norm_latents", lp["attn"]["norm_latents"])
        for n in ("to_q", "to_kv", "to_out"):
            out[f"{a}.{n}.weight"] = _f32(lp["attn"][n]["w"]).T
        _ln_out(out, f"{f}.0", lp["ff"]["norm"])
        out[f"{f}.1.weight"] = _f32(lp["ff"]["fc1"]["w"]).T
        out[f"{f}.3.weight"] = _f32(lp["ff"]["fc2"]["w"]).T
    _ln_out(out, f"{prefix}norm", params["norm"])
    return out


def state_dict_from_clip_params(params, prefix: str = "clip_model."
                                ) -> Dict[str, torch.Tensor]:
    """The vision tree -> HF CLIPVisionTransformer keys."""
    params = _tree(params)
    pe = _f32(params["patch_embed"]["w"]).T              # (d, 3 * p * p)
    side = int(round((pe.shape[1] // 3) ** 0.5))
    out: Dict[str, torch.Tensor] = {
        f"{prefix}embeddings.class_embedding": _f32(params["class_embedding"]),
        f"{prefix}embeddings.patch_embedding.weight":
            pe.reshape(pe.shape[0], 3, side, side),
        f"{prefix}embeddings.position_embedding.weight":
            _f32(params["pos_embed"]["table"])}
    _ln_out(out, f"{prefix}pre_layrnorm", params["pre_ln"])
    for i, lp in enumerate(params["layers"]):
        p = f"{prefix}encoder.layers.{i}"
        _ln_out(out, f"{p}.layer_norm1", lp["ln1"])
        for n in ("q", "k", "v", "out"):
            _linear_out(out, f"{p}.self_attn.{n}_proj", lp["attn"][n])
        _ln_out(out, f"{p}.layer_norm2", lp["ln2"])
        _linear_out(out, f"{p}.mlp.fc1", lp["mlp"]["fc1"])
        _linear_out(out, f"{p}.mlp.fc2", lp["mlp"]["fc2"])
    _ln_out(out, f"{prefix}post_layernorm", params["post_ln"])
    return out


def state_dict_from_kosmos_params(params) -> Dict[str, torch.Tensor]:
    """A ``Kosmos`` (or its tree) -> the reference's consolidated layout
    (kosmosx_tpu/utils/ref_checkpoint.py:339-345): fp32 tensors on the
    parameters' device, transposed weights as views."""
    params = _tree(params)
    out = state_dict_from_clip_params(params["clip"])
    out.update(state_dict_from_resampler_params(params["resampler"]))
    out.update(state_dict_from_decoder_params(params["decoder"]))
    out["image_proj.weight"] = _f32(params["image_proj"]["w"]).T
    return out


def save_reference_checkpoint(params, path: str) -> None:
    """A ``Kosmos`` as a reference-format ``final_model.pt`` (contiguous
    fp32 CPU tensors; an alias stays one tensor under two keys)."""
    host: Dict[int, torch.Tensor] = {}
    sd = state_dict_from_kosmos_params(params)
    torch.save({k: host.setdefault(id(v), v.cpu().contiguous())
                for k, v in sd.items()}, path)
