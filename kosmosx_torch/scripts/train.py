"""Training CLI (counterpart of scripts/train.py).

  # text-only decoder, synthetic data, a tiny smoke run on the CPU
  python -m kosmosx_torch.scripts.train --model language --synthetic \\
      --steps 50 --layers 2 --dim 64 --ffn-dim 128 --heads 4 --seq-len 64 \\
      --device cpu

  # the flagship decoder on one-document-per-line text, on the card
  python -m kosmosx_torch.scripts.train --model language \\
      --text-files corpus.txt --seq-len 2048 --max-positions 2050 \\
      --batch-size 2 --remat --optimizer lion8bit --grad-accum 2

  # Kosmos on an image+caption directory (captions.jsonl + images)
  python -m kosmosx_torch.scripts.train --model kosmos --dataset-dir data/ \\
      --seq-len 1984 --batch-size 2 --freeze-vision --optimizer adamw8bit

The flags and defaults are the JAX CLI's, and ``--device`` (default
``cuda``) picks the device. The model keeps fp32 parameters and computes
in ``--dtype``; dropout runs at the config's defaults (0.1 on the
residuals and the attention probabilities; attention dropout takes the
plain attention path, as in JAX). A checkpoint lands in
``{output-dir}/step_{n}`` every ``--checkpoint-every`` steps, ``--resume``
continues from the newest one (the JAX CLI's orbax checkpoints too, with
their optax state; reading them needs ``tensorstore``), and the
parameters alone go to ``{output-dir}/final`` at the end.

``--lora-rank R`` trains LoRA factors over the frozen base (``LoraTrainer``)
and saves them to ``{output-dir}/adapter``, which the serving CLI loads
with ``--adapter NAME={output-dir}/adapter``; ``final`` then holds the
merged parameters. ``--dpo PREFS.jsonl`` (``--model language``) trains on
``{prompt, chosen, rejected}`` rows against a frozen reference: the base
under LoRA, else a copy of the starting parameters; its log-probs are
attached to each batch outside the step, so prefetch is off:

  python -m kosmosx_torch.scripts.train --model language --dpo prefs.jsonl \
      --lora-rank 16 --seq-len 512 --batch-size 4 --optimizer adamw

``--moe-experts E`` makes every decoder FFN a token-routed mixture of E
experts (``--moe-top-k``, ``--moe-capacity-factor``); the routing loss is
added to the loss and logged as ``moe_aux``:

  python -m kosmosx_torch.scripts.train --model language --synthetic \
      --moe-experts 4 --no-multiway --seq-len 2048 --max-positions 2050 \
      --batch-size 2 --remat --remat-policy dots

``--init-checkpoint DIR`` starts from a params directory: ``final`` of an
earlier run, ``kosmosx_torch.scripts.import_reference``'s output (with
``--model kosmos``), or a params-only orbax checkpoint of the JAX package.

``--distributed`` trains over several processes, one for each rank, from
torchrun's environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; ``parallel.mesh.initialize_distributed``): each rank
streams its round-robin share of the batches (``shard_stream``), so the
global batch is ``--batch-size`` x processes; ``--data``/``--fsdp`` shape
the mesh (``--data -1`` takes the rest). Rank 0 alone writes checkpoints,
the final parameters and the metrics file:

  torchrun --nproc-per-node 8 -m kosmosx_torch.scripts.train \
      --distributed --fsdp 8 --model language --synthetic --steps 100

NCCL needs a card for each process of a node; with more processes than
cards the ranks talk over gloo. ``--tensor N`` cuts the decoder layers
over N ranks (Megatron's layout, ``parallel/tensor.py``) and ``--expert N``
the MoE expert stacks; ranks that differ only in those dims read the same
batches (the stream is sharded over ``data`` x ``fsdp``):

  torchrun --nproc-per-node 4 -m kosmosx_torch.scripts.train \
      --distributed --tensor 2 --model language --synthetic --steps 100
"""

from __future__ import annotations

import argparse
import copy
import itertools
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    # model
    p.add_argument("--model", choices=["language", "kosmos"], default="language")
    p.add_argument("--vocab-size", type=int, default=32002)
    p.add_argument("--dim", type=int, default=2048)
    p.add_argument("--layers", type=int, default=24)
    p.add_argument("--ffn-dim", type=int, default=8192)
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--max-positions", type=int, default=2048)
    p.add_argument("--no-multiway", action="store_true")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="a token-routed MoE FFN of this many experts "
                        "(nn/moe.py); 0 = dense")
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--moe-capacity-factor", type=float, default=1.25)
    # vision tower / resampler (kosmos model; defaults = CLIP ViT-L/14)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--patch-size", type=int, default=14)
    p.add_argument("--vision-dim", type=int, default=1024)
    p.add_argument("--vision-layers", type=int, default=24)
    p.add_argument("--vision-heads", type=int, default=16)
    p.add_argument("--vision-mlp-dim", type=int, default=4096)
    p.add_argument("--freeze-vision", action="store_true",
                   help="freeze the CLIP tower (kosmos model only): no "
                        "gradients, no backward activations and no "
                        "optimizer moments for it")
    p.add_argument("--resampler-depth", type=int, default=2)
    p.add_argument("--latents", type=int, default=64,
                   help="resampler latents = image embed length")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--no-flash", action="store_true")
    p.add_argument("--scan-layers", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="activation checkpointing of each decoder layer")
    p.add_argument("--remat-policy", default="nothing",
                   choices=["nothing", "dots", "dots_no_batch"])
    # training
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=8192)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=0.1)
    p.add_argument("--optimizer", default="lion",
                   choices=["lion", "adamw", "stable_adamw", "adamw8bit",
                            "lion8bit"])
    p.add_argument("--schedule", default="cosine",
                   choices=["cosine", "linear", "constant"])
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--warmup-steps", type=int, default=None)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--eval-every", type=int, default=0,
                   help="validation cadence in steps (0 = off)")
    p.add_argument("--eval-pretokenized", nargs="*", default=None,
                   help="held-out pretokenized token files for --eval-every")
    p.add_argument("--eval-batches", type=int, default=16,
                   help="validation batches per evaluation")
    p.add_argument("--output-dir", default="checkpoints/")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-final-save", action="store_true",
                   help="skip the final params-only save to "
                        "{output-dir}/final")
    # LoRA fine-tuning
    p.add_argument("--lora-rank", type=int, default=0,
                   help="train low-rank adapters instead of full params")
    p.add_argument("--lora-alpha", type=float, default=None)
    p.add_argument("--lora-targets", default="q,k,v,out,fc1,fc2",
                   help="comma-separated linear names to adapt")
    p.add_argument("--init-checkpoint", default=None,
                   help="params-only checkpoint dir to start from (a prior "
                        "run's {output-dir}/final)")
    # mesh
    p.add_argument("--data", type=int, default=-1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tensor", type=int, default=1)
    p.add_argument("--expert", type=int, default=1,
                   help="expert-parallel mesh axis size (MoE)")
    # data
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic batches (no dataset needed)")
    p.add_argument("--text-files", nargs="*", default=None,
                   help="one-doc-per-line text files")
    p.add_argument("--hf-dataset", default=None,
                   help="Hugging Face dataset name for on-the-fly tokenized "
                        "training; needs the datasets package and the "
                        "dataset in its local cache")
    p.add_argument("--hf-split", default="train")
    p.add_argument("--dpo", default=None, metavar="PREFS.jsonl",
                   help="DPO preference fine-tuning from JSONL rows "
                        "{prompt, chosen, rejected}; the frozen reference = "
                        "the starting params (--init-checkpoint or the "
                        "fresh init); --model language only")
    p.add_argument("--dpo-beta", type=float, default=0.1)
    p.add_argument("--hf-text-key", default="text")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training from torchrun's environment "
                        "(WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT); each "
                        "process streams a disjoint round-robin share of the "
                        "batches (global batch = batch-size x processes). "
                        "Cap the run with --steps so uneven stream tails "
                        "cannot desync the processes.")
    p.add_argument("--pretokenized", nargs="*", default=None,
                   help="pretokenized token files (.bin memmap / .npy), "
                        "re-chunked to --seq-len")
    p.add_argument("--token-dtype", default=None,
                   help="dtype of raw .bin token files (default: sidecar "
                        "json, else uint16)")
    p.add_argument("--dataset-dir", default=None,
                   help="on-disk image+caption dataset dir (captions.jsonl "
                        "+ image files) for --model kosmos")
    p.add_argument("--captions-file", default="captions.jsonl")
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="record the program's spans and write them to PATH "
                        "as Chrome trace JSON at exit (Perfetto); under "
                        "--distributed each rank writes PATH.rank<r>")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from kosmosx_torch.utils import trace

    out = args.trace_out
    if out is not None and args.distributed:
        out = f"{out}.rank{os.environ.get('RANK', '0')}"
    with trace.to_chrome(out):
        return _train(args)


def _train(args) -> int:
    import torch

    from kosmosx_torch.core.config import (KosmosConfig, MagnetoConfig,
                                           ResamplerConfig, VisionConfig)
    from kosmosx_torch.data.tokenizer import KosmosTokenizer
    from kosmosx_torch.train import checkpoint as ckpt
    from kosmosx_torch.train.data import (hf_dataset_stream,
                                          image_caption_batches,
                                          packed_text_batches,
                                          preference_jsonl_batches,
                                          pretokenized_batches,
                                          shard_stream,
                                          synthetic_multimodal_batches,
                                          synthetic_text_batches,
                                          text_file_stream)
    from kosmosx_torch.train.metrics import MetricsLogger
    from kosmosx_torch.train.trainer import (TrainConfig, Trainer,
                                             kosmos_loss_fn, lm_loss_fn)

    shard, mesh, writer = None, None, True
    if args.distributed:
        from kosmosx_torch.parallel.mesh import (initialize_distributed,
                                                 make_mesh)
        from kosmosx_torch.parallel.sharding import batch_shards

        if initialize_distributed():
            import torch.distributed as dist

            # the stream splits over the batch's ranks (data x fsdp); the
            # tensor and expert ranks of one batch shard read the same rows
            mesh = make_mesh(data=args.data, fsdp=args.fsdp,
                             tensor=args.tensor, expert=args.expert)
            shard = batch_shards(mesh)
            writer = dist.get_rank() == 0
    # a synthetic stream long enough for --steps on every process
    synthetic_steps = args.steps * (1 if shard is None else shard[1])
    if args.dpo and args.model != "language":
        raise SystemExit("--dpo trains the text decoder: --model language")

    dev = torch.device(args.device)
    dcfg = MagnetoConfig(
        vocab_size=args.vocab_size, embed_dim=args.dim, layers=args.layers,
        ffn_dim=args.ffn_dim, heads=args.heads,
        max_positions=args.max_positions, multiway=not args.no_multiway,
        compute_dtype=args.dtype, use_flash_attention=not args.no_flash,
        scan_layers=args.scan_layers, remat=args.remat,
        remat_policy=args.remat_policy, moe_experts=args.moe_experts,
        moe_top_k=args.moe_top_k,
        moe_capacity_factor=args.moe_capacity_factor)
    tcfg = TrainConfig(
        batch_size=args.batch_size, grad_accum=args.grad_accum,
        seq_len=args.seq_len, seed=args.seed, learning_rate=args.lr,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        optimizer=args.optimizer, schedule=args.schedule,
        total_steps=args.steps, warmup_steps=args.warmup_steps,
        checkpoint_every=args.checkpoint_every, log_every=args.log_every,
        eval_every=args.eval_every, prefetch=not args.dpo,
        per_process_batches=shard is not None,
        output_dir=args.output_dir,
        resume=args.resume, final_save=not args.no_final_save,
        data=args.data, fsdp=args.fsdp, tensor=args.tensor,
        expert=args.expert,
        freeze=("clip",) if args.freeze_vision else ())

    if args.model == "language":
        from kosmosx_torch.models.language import KosmosLanguage

        def init_fn(g):
            return KosmosLanguage(dcfg, generator=g, device=dev)

        loss_fn = lm_loss_fn(dcfg)
        if args.dpo:
            from kosmosx_torch.train.dpo import dpo_loss_fn

            loss_fn = dpo_loss_fn(dcfg, beta=args.dpo_beta)
            batches = preference_jsonl_batches(
                args.dpo, KosmosTokenizer(), batch_size=args.batch_size,
                length=args.seq_len, epochs=None)
        elif args.synthetic:
            batches = synthetic_text_batches(
                batch_size=args.batch_size, seq_len=args.seq_len,
                vocab_size=args.vocab_size, steps=synthetic_steps)
        elif args.pretokenized:
            batches = pretokenized_batches(
                args.pretokenized, batch_size=args.batch_size,
                seq_len=args.seq_len, dtype=args.token_dtype)
        elif args.hf_dataset or args.text_files:
            tok = KosmosTokenizer()
            docs = hf_dataset_stream(
                args.hf_dataset, tok, split=args.hf_split,
                text_key=args.hf_text_key) if args.hf_dataset else \
                text_file_stream(args.text_files, tok)
            batches = packed_text_batches(
                docs, batch_size=args.batch_size, seq_len=args.seq_len,
                eos_id=tok.eos_token_id)
        else:
            raise SystemExit("need --synthetic, --pretokenized, "
                             "--hf-dataset, or --text-files")
    else:
        from kosmosx_torch.models.kosmos import Kosmos

        vcfg = VisionConfig(
            image_size=args.image_size, patch_size=args.patch_size,
            hidden_dim=args.vision_dim, layers=args.vision_layers,
            heads=args.vision_heads, mlp_dim=args.vision_mlp_dim,
            compute_dtype=args.dtype)
        rcfg = ResamplerConfig(
            dim=args.vision_dim, depth=args.resampler_depth,
            num_latents=args.latents, num_media_embeds=vcfg.seq_len,
            compute_dtype=args.dtype)
        kcfg = KosmosConfig(decoder=dcfg, vision=vcfg, resampler=rcfg,
                            image_embed_len=args.latents)

        def init_fn(g):
            return Kosmos(kcfg, generator=g, device=dev)

        loss_fn = kosmos_loss_fn(kcfg)
        if args.synthetic:
            batches = synthetic_multimodal_batches(
                batch_size=args.batch_size, seq_len=args.seq_len,
                vocab_size=args.vocab_size, image_size=args.image_size,
                steps=synthetic_steps)
        elif args.dataset_dir:
            tok = KosmosTokenizer(image_size=args.image_size,
                                  image_embed_len=args.latents)
            batches = image_caption_batches(
                args.dataset_dir, tok, batch_size=args.batch_size,
                text_len=args.seq_len, captions_file=args.captions_file,
                epochs=None)
        else:
            raise SystemExit("kosmos training needs --synthetic or "
                             "--dataset-dir (captions.jsonl + images)")

    if shard is not None:
        # every source shards at batch granularity: an equal rate for every
        # process, and disjoint data (kosmosx_tpu's scripts/train.py:282-286)
        batches = shard_stream(batches, *shard)

    base_params = None
    if args.init_checkpoint:
        # warm start: the seeded init's parameters, overwritten in place
        base_params = init_fn(torch.Generator(device=dev).manual_seed(
            args.seed))
        ckpt.restore_params(args.init_checkpoint, base_params)
    if args.lora_rank > 0:
        from kosmosx_torch.train.lora import LoraTrainer

        trainer = LoraTrainer(
            init_fn=init_fn, loss_fn=loss_fn, cfg=tcfg, rank=args.lora_rank,
            alpha=args.lora_alpha,
            targets=tuple(t for t in args.lora_targets.split(",") if t),
            mesh=mesh, base_params=base_params, device=dev)
    else:
        trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn, cfg=tcfg,
                          mesh=mesh, device=dev)
        if base_params is not None:
            trainer.init_state(initial_params=base_params)
    log_fn = MetricsLogger(jsonl_path=args.metrics_jsonl,
                           use_wandb=args.wandb,
                           config=vars(args)) if writer and (
                               args.metrics_jsonl or args.wandb) else None

    eval_fn = None
    if args.eval_every and args.eval_pretokenized:
        def eval_fn():
            return itertools.islice(
                pretokenized_batches(args.eval_pretokenized,
                                     batch_size=args.batch_size,
                                     seq_len=args.seq_len,
                                     dtype=args.token_dtype),
                args.eval_batches)

    if args.dpo:
        # the frozen reference: the LoRA base, or a copy of the starting
        # parameters (the optimizer updates the policy in place); its
        # log-probs attach to each batch outside the step
        from kosmosx_torch.train.dpo import compute_ref_logprobs

        if trainer.state is None:
            trainer.init_state()
        ref = trainer.base_params if args.lora_rank > 0 else \
            copy.deepcopy(trainer.state["params"]).requires_grad_(False)
        batches = (compute_ref_logprobs(ref, dcfg, b) for b in batches)

    state, metrics = trainer.run(batches, steps=args.steps, log_fn=log_fn,
                                 eval_batches=eval_fn)
    if log_fn is not None:
        log_fn.close()
    if args.lora_rank > 0 and not args.no_final_save and writer:
        # the factors alone, in the format of scripts/serve.py --adapter
        from kosmosx_torch.train.lora import lora_state_dict

        ckpt.save_params({n: t.detach() for n, t in
                          lora_state_dict(state["lora"]).items()},
                         os.path.join(args.output_dir, "adapter"))
    print("final:", {k: float(v) for k, v in metrics.items()})
    if mesh is not None:
        import torch.distributed as dist

        # every rank past its last collective before any tears its group
        # down: under gloo a rank that exits while its peer still finishes
        # the last collective can abort at exit ("terminate called without
        # an active exception")
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
