"""The program under test, built from a configuration file: the port's
configuration objects and its model on the benchmark's weights."""

from __future__ import annotations

from typing import Dict

import torch

# the config file's decoder keys that are the port's MagnetoConfig fields
_DECODER_KEYS = ("vocab_size", "embed_dim", "ffn_dim", "layers", "heads",
                 "max_positions", "padding_idx", "dropout",
                 "attention_dropout", "activation_dropout", "activation",
                 "subln", "multiway", "xpos_rel_pos", "xpos_scale_base",
                 "scale_embedding", "activation_fp32")
_VISION_KEYS = ("image_size", "patch_size", "hidden_dim", "layers", "heads",
                "mlp_dim", "layer_norm_eps", "activation")
_RESAMPLER_KEYS = ("dim", "depth", "dim_head", "heads", "num_latents",
                   "num_media_embeds", "ff_mult")


def kosmos_config(cfg: dict, **decoder):
    """The port's ``KosmosConfig`` for a configuration file, every part in
    its ``compute_dtype``, the decoder in the stacked layout where the
    weights are weight-only int8; ``decoder`` sets further decoder fields
    (remat, the decode kernel)."""
    from kosmosx_torch.core import config as c

    dtype = cfg["compute_dtype"]
    d = {k: cfg["decoder"][k] for k in _DECODER_KEYS}
    decoder.setdefault("scan_layers", cfg["weights"] == "w8")
    return c.KosmosConfig(
        decoder=c.MagnetoConfig(compute_dtype=dtype, **d, **decoder),
        vision=c.VisionConfig(compute_dtype=dtype,
                              **{k: cfg["vision"][k] for k in _VISION_KEYS}),
        resampler=c.ResamplerConfig(
            compute_dtype=dtype,
            **{k: cfg["resampler"][k] for k in _RESAMPLER_KEYS}),
        image_embed_len=cfg["image_embed_len"],
        splice_index=cfg["splice_index"],
        parity_double_scale=cfg["parity_double_scale"])


def build_model(kcfg, flat: Dict[str, torch.Tensor]):
    """``Kosmos`` over the benchmark's weights (``{dotted path: tensor}``),
    quantized to weight-only int8 where the config's decoder is stacked
    (``scan_layers``: the W8 layout)."""
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.utils.quantize import quantize_params_w8

    from perfbench.reference.kosmos import nest

    model = Kosmos(kcfg, params=nest(flat))
    if kcfg.decoder.scan_layers:
        model = quantize_params_w8(model)
    return model

