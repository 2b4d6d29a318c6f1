"""Perplexity-evaluation CLI (counterpart of scripts/eval.py): a
``KosmosLanguage`` decoder, from a ``Trainer`` checkpoint directory or a
random init, over packed one-document-per-line text files.

  python -m kosmosx_torch.scripts.eval --layers 2 --dim 64 --ffn-dim 128 \\
      --heads 4 --data corpus.txt --seq-len 512 --batch-size 4 --device cpu

  python -m kosmosx_torch.scripts.eval --checkpoint checkpoints/ \\
      --data val.txt --max-positions 2050

The flags and defaults are the JAX CLI's, and ``--device`` (default
``cuda``) picks the device. The model is built from ``--seed`` in
``--dtype`` (parameters too), dropout off; ``--checkpoint`` loads the
parameters of its newest ``step_*`` directory into it. Prints one JSON
object: perplexity, cross entropy, tokens and batches.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--vocab-size", type=int, default=32002)
    p.add_argument("--dim", type=int, default=2048)
    p.add_argument("--layers", type=int, default=24)
    p.add_argument("--ffn-dim", type=int, default=8192)
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--max-positions", type=int, default=2048)
    p.add_argument("--no-multiway", action="store_true")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--checkpoint", default=None,
                   help="Trainer output dir; loads the latest step")
    p.add_argument("--data", required=True, nargs="+",
                   help="text files, one document per line")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from kosmosx_torch.core.config import MagnetoConfig
    from kosmosx_torch.data.tokenizer import KosmosTokenizer
    from kosmosx_torch.eval import evaluate_perplexity
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.train import checkpoint as ckpt
    from kosmosx_torch.train.data import packed_text_batches, text_file_stream

    dev = torch.device(args.device)
    dcfg = MagnetoConfig(
        vocab_size=args.vocab_size, embed_dim=args.dim, layers=args.layers,
        ffn_dim=args.ffn_dim, heads=args.heads,
        max_positions=args.max_positions, multiway=not args.no_multiway,
        compute_dtype=args.dtype, dropout=0.0, attention_dropout=0.0)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    model = KosmosLanguage(dcfg, generator=g, device=dev).to(dcfg.dtype)
    if args.checkpoint:
        found = ckpt.latest_checkpoint(args.checkpoint)
        if not found:
            raise SystemExit(f"no checkpoint under {args.checkpoint}")
        ckpt.restore_state_params(found[0], model)
        print(f"loaded {found[0]} (step {found[1]})", file=sys.stderr)

    tok = KosmosTokenizer()
    batches = packed_text_batches(
        text_file_stream(args.data, tok),
        batch_size=args.batch_size, seq_len=args.seq_len,
        eos_id=tok.eos_token_id)
    out = evaluate_perplexity(model, batches, dcfg,
                              max_batches=args.max_batches)
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
