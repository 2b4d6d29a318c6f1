"""Generation CLI: load a checkpoint (or random-init) and generate
(counterpart of scripts/generate.py).

  # text-only, random init, greedy, on the card
  python -m kosmosx_torch.scripts.generate --model language --layers 2 \\
      --dim 64 --ffn-dim 128 --heads 4 --prompt "hello world" \\
      --max-new-tokens 16 --greedy

  # Kosmos on an image, beam search
  python -m kosmosx_torch.scripts.generate --model kosmos --image img.npy \\
      --beam-size 4

  # from a Trainer checkpoint directory, on the CPU
  python -m kosmosx_torch.scripts.generate --checkpoint checkpoints/ \\
      --device cpu --prompt "..." --temperature 0.8 --top-p 0.95

The flags and defaults are the JAX CLI's, and ``--device`` (default
``cuda``) picks the device. Random weights are built from ``--seed`` on the
device and cast to ``--dtype``; ``--w8`` quantizes them after the cast.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=["language", "kosmos"], default="language")
    p.add_argument("--vocab-size", type=int, default=32002)
    p.add_argument("--dim", type=int, default=2048)
    p.add_argument("--layers", type=int, default=24)
    p.add_argument("--ffn-dim", type=int, default=8192)
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--max-positions", type=int, default=2048)
    p.add_argument("--kv-window", type=int, default=0,
                   help="rolling KV cache (StreamingLLM sinks + ring): "
                        "unbounded generation length at O(window) memory")
    p.add_argument("--kv-sink", type=int, default=4)
    p.add_argument("--no-multiway", action="store_true")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--checkpoint", default=None,
                   help="Trainer output dir (loads the latest step) or "
                        "a params dir (import_reference's, orbax's)")
    p.add_argument("--prompt", default="The")
    p.add_argument("--image", default=None,
                   help="path to a .npy (3,H,W) image for --model kosmos")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--beam-size", type=int, default=0,
                   help="beam-search decoding with this many beams "
                        "(text or kosmos; overrides sampling flags)")
    p.add_argument("--length-penalty", type=float, default=1.0)
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--w8", action="store_true",
                   help="weight-only int8 inference (~half the weight bytes "
                        "read per decode step)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from kosmosx_torch.core.config import (KosmosConfig, MagnetoConfig,
                                           ResamplerConfig, VisionConfig)
    from kosmosx_torch.data.tokenizer import KosmosTokenizer
    from kosmosx_torch.generate import beam
    from kosmosx_torch.generate.sampler import (SamplingConfig,
                                                generate_multimodal,
                                                generate_text)

    dev = torch.device(args.device)
    dcfg = MagnetoConfig(
        vocab_size=args.vocab_size, embed_dim=args.dim, layers=args.layers,
        ffn_dim=args.ffn_dim, heads=args.heads,
        max_positions=args.max_positions, multiway=not args.no_multiway,
        compute_dtype=args.dtype, dropout=0.0, attention_dropout=0.0,
        kv_window=args.kv_window, kv_sink=args.kv_sink)
    scfg = SamplingConfig(max_new_tokens=args.max_new_tokens,
                          temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, greedy=args.greedy)
    tok = KosmosTokenizer()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    beam_kw = dict(beam_size=args.beam_size,
                   max_new_tokens=args.max_new_tokens,
                   length_penalty=args.length_penalty, eos_id=args.eos_id)

    if args.model == "language":
        from kosmosx_torch.models.language import KosmosLanguage

        model = _prepare(KosmosLanguage(dcfg, generator=g, device=dev), args)
        ids, _ = tok.tokenize_texts(args.prompt, modalities=())
        ids = torch.as_tensor(ids, device=dev).long()
        if args.beam_size > 0:
            toks, norm, _ = beam.beam_search(model, dcfg, ids, **beam_kw)
            print(f"# best beam score {float(norm[0, 0]):.4f}",
                  file=sys.stderr)
            out = toks[:, 0]
        else:
            out = generate_text(model, dcfg, ids, scfg, generator=g)
    else:
        from kosmosx_torch.models.kosmos import Kosmos

        kcfg = KosmosConfig(decoder=dcfg,
                            vision=VisionConfig(compute_dtype=args.dtype),
                            resampler=ResamplerConfig(compute_dtype=args.dtype))
        model = _prepare(Kosmos(kcfg, generator=g, device=dev), args)
        ids, _ = tok.tokenize_texts(args.prompt)
        ids = torch.as_tensor(ids, device=dev).long()
        if args.image:
            img = np.load(args.image)[None]
        else:
            img = np.random.RandomState(0).rand(1, 3, 224, 224).astype(
                np.float32)
        imgs = tok.tokenize_images(torch.as_tensor(img, device=dev))
        if args.beam_size > 0:
            toks, norm, _ = beam.beam_search_multimodal(model, kcfg, ids, imgs,
                                                        **beam_kw)
            print(f"# best beam score {float(norm[0, 0]):.4f}",
                  file=sys.stderr)
            out = toks[:, 0]
        else:
            out = generate_multimodal(model, kcfg, ids, imgs, scfg,
                                      generator=g)

    ids_out = out[0].tolist()
    print("generated ids:", ids_out)
    print("decoded:", tok.decode(ids_out))
    return 0


def _prepare(model, args):
    """The random model in the compute dtype, loaded from ``--checkpoint``
    (a Trainer output directory's newest step, else a params directory:
    ``save_params``'s, ``import_reference``'s or the JAX package's orbax
    one) and quantized under ``--w8``."""
    from kosmosx_torch.train import checkpoint as ckpt
    from kosmosx_torch.utils.quantize import quantize_params_w8

    model = model.to(model.config.dtype)
    if args.checkpoint:
        found = ckpt.latest_checkpoint(args.checkpoint)
        if found:
            ckpt.restore_state_params(found[0], model)
            print(f"loaded {found[0]} (step {found[1]})")
        elif ckpt.is_params_checkpoint(args.checkpoint):
            ckpt.restore_params(args.checkpoint, model)
            print(f"loaded {args.checkpoint}")
        else:
            raise SystemExit(f"no checkpoint under {args.checkpoint}")
    return quantize_params_w8(model) if args.w8 else model


if __name__ == "__main__":
    sys.exit(main())
