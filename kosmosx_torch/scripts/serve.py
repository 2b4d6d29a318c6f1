"""Serving CLI: load a model and serve prompts through the
continuous-batching engine (counterpart of scripts/serve.py).

  # random-init smoke run on the CPU, 3 prompts through 2 slots
  python -m kosmosx_torch.scripts.serve --device cpu --layers 2 --dim 64 \\
      --ffn-dim 128 --heads 2 --max-positions 128 --dtype float32 \\
      --no-flash --slots 2 --prompt "a b c" --prompt "d e" --prompt "f" \\
      --max-new-tokens 8

  # the flagship on the card from a Trainer checkpoint, W8 and int8 KV
  python -m kosmosx_torch.scripts.serve --checkpoint checkpoints/ \\
      --sync-lag 4 --decode-block 4 --w8 --kv8 --prompts-file prompts.txt

  # multimodal: the i-th --image (.npy, (3, H, W), uint8 or float) goes
  # with the i-th prompt
  python -m kosmosx_torch.scripts.serve --model kosmos \\
      --prompt "describe this" --image img.npy

  # HTTP (serve/server.py): POST /v1/completions, /v1/cancel,
  # GET /healthz, /v1/stats
  python -m kosmosx_torch.scripts.serve --http 8000 --sync-lag 4

  # the engine's spans (utils/trace.py) as Chrome trace JSON at exit
  python -m kosmosx_torch.scripts.serve --trace-out serve.trace.json ...

The flags and defaults are the JAX CLI's, and ``--device`` (default
``cuda``) picks the device. Prompts come from repeated ``--prompt``,
``--prompts-file`` (one per line) or stdin. Outputs print as ``[req <id>]
<decoded text>`` in submission order, then a tokens/s line on stderr. The
decoder runs with ``decode_attn_kernel=True`` (the decode kernel at every
decode step, the plain version on the CPU) and ``scan_layers=True``
(``--w8`` then stacks the decoder's codes for the stacked W8 kernel).
Random weights come from ``--seed``; ``--checkpoint`` loads a Trainer
checkpoint (``train/checkpoint.py``), ``--adapter NAME=PATH`` a LoRA
adapter saved with ``save_params(lora_state_dict(tree), PATH)``.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=["language", "kosmos"],
                   default="language")
    p.add_argument("--image", action="append", default=None,
                   help="repeatable .npy (3,H,W); pairs with the i-th "
                        "prompt (--model kosmos)")
    p.add_argument("--vocab-size", type=int, default=32002)
    p.add_argument("--dim", type=int, default=2048)
    p.add_argument("--layers", type=int, default=24)
    p.add_argument("--ffn-dim", type=int, default=8192)
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--max-positions", type=int, default=8194)
    p.add_argument("--no-multiway", action="store_true")
    p.add_argument("--no-flash", action="store_true")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--checkpoint", default=None,
                   help="Trainer output dir (loads the latest step) or "
                        "a params dir (import_reference's, orbax's)")
    p.add_argument("--prompt", action="append", default=None,
                   help="repeatable; falls back to --prompts-file or stdin")
    p.add_argument("--prompts-file", default=None)
    p.add_argument("--system-prefix", default=None,
                   help="shared system-prompt text: prepended to every "
                        "prompt and its KV cache registered once "
                        "(ServeEngine.register_prefix)")
    p.add_argument("--share-prefix", action="store_true",
                   help="with --system-prefix: one broadcast KV segment, "
                        "no per-slot copies")
    p.add_argument("--adapter", action="append", default=None,
                   metavar="NAME=PATH",
                   help="repeatable: load a LoRA adapter for multi-LoRA "
                        "serving; HTTP requests pick one with the "
                        "'adapter' field, CLI prompts with --use-adapter")
    p.add_argument("--use-adapter", default=None,
                   help="serve every CLI prompt through this adapter")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--greedy", action="store_true", default=True)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="> 0 switches to temperature sampling")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max-prompt-len", type=int, default=128)
    p.add_argument("--sync-lag", type=int, default=4)
    p.add_argument("--decode-block", type=int, default=0)
    p.add_argument("--prefill-chunk", type=int, default=0)
    p.add_argument("--w8", action="store_true",
                   help="weight-only int8 (the W8 kernels)")
    p.add_argument("--kv8", action="store_true", help="int8 KV cache")
    p.add_argument("--kv-window", type=int, default=0,
                   help="rolling KV window (sinks + ring): slot caches hold "
                        "kv-window positions however long generations run")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve over HTTP instead of batch prompts")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the warmup before taking HTTP traffic")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="record the program's spans and write them to PATH "
                        "as Chrome trace JSON at exit (Perfetto)")
    return p


def _load_adapters(eng, specs):
    """--adapter NAME=PATH entries -> ServeEngine.load_adapter."""
    from kosmosx_torch.train.checkpoint import restore_params
    from kosmosx_torch.train.lora import lora_from_state_dict

    for spec in specs or ():
        name, _, path = spec.partition("=")
        if not name or not path:
            raise SystemExit(f"--adapter needs NAME=PATH, got {spec!r}")
        eng.load_adapter(name, lora_from_state_dict(restore_params(path)))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from kosmosx_torch.utils import trace

    with trace.to_chrome(args.trace_out):
        return _serve(args)


def _serve(args) -> int:
    import numpy as np
    import torch

    from kosmosx_torch.core.config import (KosmosConfig, MagnetoConfig,
                                           ResamplerConfig, VisionConfig)
    from kosmosx_torch.data.tokenizer import KosmosTokenizer
    from kosmosx_torch.generate.sampler import SamplingConfig
    from kosmosx_torch.scripts.generate import _prepare
    from kosmosx_torch.serve import ServeConfig, ServeEngine

    dev = torch.device(args.device)
    cfg = MagnetoConfig(
        vocab_size=args.vocab_size, embed_dim=args.dim, layers=args.layers,
        ffn_dim=args.ffn_dim, heads=args.heads,
        max_positions=args.max_positions, multiway=not args.no_multiway,
        use_flash_attention=not args.no_flash, compute_dtype=args.dtype,
        scan_layers=True, dropout=0.0, attention_dropout=0.0,
        kv_cache_dtype="int8" if args.kv8 else None,
        kv_window=args.kv_window, decode_attn_kernel=True)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    kcfg = None
    if args.model == "kosmos":
        from kosmosx_torch.models.kosmos import Kosmos

        kcfg = KosmosConfig(decoder=cfg,
                            vision=VisionConfig(compute_dtype=args.dtype),
                            resampler=ResamplerConfig(compute_dtype=args.dtype))
        model = _prepare(Kosmos(kcfg, generator=g, device=dev), args)
    else:
        from kosmosx_torch.models.language import KosmosLanguage

        model = _prepare(KosmosLanguage(cfg, generator=g, device=dev), args)
    tok = KosmosTokenizer()

    def ids_of(text):
        ids, _ = tok.tokenize_texts(text, modalities=())
        return [int(t) for t in np.asarray(ids).reshape(-1)]

    prefix_ids = ids_of(args.system_prefix) if args.system_prefix else None

    def with_prefix(ids):
        """The system prefix before the prompt (the prompt's BOS dropped);
        too long a combination fails instead of cutting the user's text."""
        if prefix_ids is None:
            return ids
        if ids and ids[0] == prefix_ids[0]:
            ids = ids[1:]
        out = prefix_ids + ids
        if len(out) > args.max_prompt_len:
            raise SystemExit(
                f"system prefix ({len(prefix_ids)}) + prompt ({len(ids)}) "
                f"exceeds --max-prompt-len {args.max_prompt_len}")
        return out

    scfg = ServeConfig(
        max_batch=args.slots, max_prompt_len=args.max_prompt_len,
        sync_lag=args.sync_lag, decode_block=args.decode_block,
        prefill_chunk=args.prefill_chunk,
        max_len=max(args.kv_window,
                    args.max_prompt_len + args.max_new_tokens
                    + (kcfg.image_embed_len if kcfg is not None else 0)
                    + ServeConfig(sync_lag=args.sync_lag,
                                  decode_block=args.decode_block
                                  ).overrun_window))
    sampling = (SamplingConfig(greedy=True) if args.temperature <= 0
                else SamplingConfig(greedy=False,
                                    temperature=args.temperature))
    eng = ServeEngine(model, cfg, scfg, sampling, kosmos_cfg=kcfg,
                      generator=g, device=dev)
    if prefix_ids:
        eng.register_prefix(prefix_ids, share=args.share_prefix)
    _load_adapters(eng, args.adapter)

    if args.http is not None:
        from kosmosx_torch.serve import ServeServer

        class _Tok:  # the server's encode/decode
            def encode(self, s):
                return with_prefix(ids_of(s))[:args.max_prompt_len]

            def decode(self, ids):
                return tok.decode(ids)

        wimg = None
        if kcfg is not None and not args.no_warmup:
            size = kcfg.vision.image_size
            wimg = torch.zeros((1, 3, size, size), device=dev)
        srv = ServeServer(eng, host=args.host, port=args.http,
                          tokenizer=_Tok(),
                          default_max_tokens=args.max_new_tokens,
                          warmup=not args.no_warmup, warmup_images=wimg)
        srv.start()
        print(f"serving on http://{srv.address[0]}:{srv.address[1]} "
              f"(ctrl-c to stop)", file=sys.stderr)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            srv.stop()
        return 0

    if args.prompt:
        texts = args.prompt
    elif args.prompts_file:
        with open(args.prompts_file) as f:
            texts = [ln.rstrip("\n") for ln in f if ln.strip()]
    else:
        texts = [ln.rstrip("\n") for ln in sys.stdin if ln.strip()]
    if not texts:
        raise SystemExit("no prompts (use --prompt / --prompts-file / stdin)")
    prompts = [with_prefix(ids_of(t))[:args.max_prompt_len] for t in texts]
    images = []
    for i in range(len(prompts)):
        if kcfg is not None and args.image and i < len(args.image):
            img = torch.as_tensor(np.load(args.image[i])[None], device=dev)
            images.append(tok.tokenize_images(img)[0])
        else:
            images.append(None)

    t0 = time.perf_counter()
    handles = []
    pending = list(zip(prompts, images))

    def admit():
        while pending and eng.num_active < args.slots:
            p, im = pending.pop(0)
            handles.append(eng.submit(p, max_new_tokens=args.max_new_tokens,
                                      eos_id=args.eos_id, images=im,
                                      adapter=args.use_adapter))

    admit()
    while True:
        alive = eng.step()
        if pending:
            admit()
            alive = True
        if not alive:
            break
    dt = time.perf_counter() - t0
    total = sum(len(h.tokens) for h in handles)
    for h in handles:
        print(f"[req {h.id}] {tok.decode(h.tokens)}")
    print(f"# {total} tokens / {len(handles)} requests in {dt:.2f}s "
          f"= {total / dt:.0f} tok/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
