"""Import the reference's artifacts into a params checkpoint of the port
(counterpart of scripts/import_reference.py).

    # the reference's consolidated final_model.pt -> a params checkpoint
    python -m kosmosx_torch.scripts.import_reference \\
        --final-model final_model.pt --out ckpts/imported

    # a local laion CLIP file (model.safetensors, pytorch_model.bin or a
    # directory holding one) grafted into a seeded Kosmos init
    python -m kosmosx_torch.scripts.import_reference \\
        --clip laion-vit-l-14/ --out ckpts/clip_init --seed 0

The output directory holds ``params.pt`` with the port's parameter names,
which ``kosmosx_torch.scripts.train --model kosmos --init-checkpoint DIR``
and ``kosmosx_torch.scripts.serve --checkpoint DIR`` load, as does
``train.checkpoint.restore_params(DIR, model)``. The model is the flagship
``KosmosConfig`` (``--config tiny-test``: the JAX tests' tiny one, its
resampler of the shape the training CLI builds) at the depths of the input:
the decoder's and the ViT's layers are counted in the state dict, the ViT's
in the CLIP file, so a depth-cut checkpoint imports as it is and the
training CLI then takes its ``--layers`` and ``--vision-layers``.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import sys


def model_config(name: str, layers=None, vision_layers=None):
    """The flagship ``KosmosConfig`` or the tiny test one
    (scripts/import_reference.py:54-89; its resampler has
    ``ResamplerConfig``'s heads and head width, as the training CLI's),
    its depths overridden."""
    from kosmosx_torch.core.config import (KosmosConfig, MagnetoConfig,
                                           ResamplerConfig, VisionConfig)

    if name == "flagship":
        cfg = KosmosConfig()
    else:
        cfg = KosmosConfig(
            decoder=MagnetoConfig(vocab_size=64, embed_dim=32, ffn_dim=64,
                                  layers=2, heads=4, max_positions=64,
                                  use_flash_attention=False, multiway=True,
                                  dropout=0.0, attention_dropout=0.0),
            vision=VisionConfig(image_size=28, patch_size=14, hidden_dim=32,
                                layers=2, heads=2, mlp_dim=64,
                                use_flash_attention=False),
            resampler=ResamplerConfig(dim=32, depth=2, num_latents=4,
                                      num_media_embeds=5),
            image_embed_len=4)
    if layers is not None:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, layers=layers))
    if vision_layers is not None:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, layers=vision_layers))
    return cfg


def count_layers(sd, pattern: str) -> int:
    """How many layers the keys of ``sd`` hold: ``pattern`` matches a key's
    start and captures its layer index."""
    return len({int(m.group(1)) for m in map(re.compile(pattern).match, sd)
                if m})


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--final-model",
                     help="the reference's consolidated final_model.pt")
    src.add_argument("--clip", help="a laion CLIP checkpoint file or "
                                    "directory, grafted into a seeded init")
    p.add_argument("--out", required=True, help="params directory to write")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="storage dtype of the written params")
    p.add_argument("--seed", type=int, default=0,
                   help="--clip: seed of the parameters outside CLIP")
    p.add_argument("--config", default="flagship",
                   choices=("flagship", "tiny-test"))
    p.add_argument("--device", default="cuda",
                   help="--clip: device of the seeded init (default: the "
                        "card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from kosmosx_torch.core.params import to_tree
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.train import checkpoint as ckpt

    if args.final_model:
        from kosmosx_torch.utils.ref_checkpoint import (
            kosmos_params_from_state_dict, strip_wrapper_prefixes)

        sd = strip_wrapper_prefixes(torch.load(
            args.final_model, map_location="cpu", weights_only=True))
        cfg = model_config(
            args.config, count_layers(sd, r"decoder\.layers\.(\d+)\."),
            count_layers(sd, r"clip_model\.(?:vision_model\.)?encoder\."
                             r"layers\.(\d+)\."))
        tree = kosmos_params_from_state_dict(sd, cfg)
    else:
        from kosmosx_torch.utils.hf_convert import load_clip_checkpoint

        clip = load_clip_checkpoint(args.clip, device=args.device)
        cfg = model_config(args.config, vision_layers=len(clip["layers"]))
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        tree = to_tree(Kosmos(cfg, generator=gen, device=args.device))
        tree["clip"] = clip
    dtype = getattr(torch, args.dtype)
    model = Kosmos(cfg, params=tree)
    params = {n: p.detach().to("cpu", dtype) for n, p in
              model.named_parameters()}
    path = ckpt.save_params(params, args.out)
    n = sum(p.numel() for p in params.values())
    print(f"wrote {n / 1e9:.3f}B params ({args.dtype}) -> {path}")
    print(f"use: python -m kosmosx_torch.scripts.train --model kosmos "
          f"--init-checkpoint {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
