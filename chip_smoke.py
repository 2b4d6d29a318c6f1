#!/usr/bin/env python3
"""Drive kosmosx_torch's serving, W8 and training slices (LoRA, QLoRA, DPO
and distillation among them), the mixture-of-experts decoder, checkpoint
import and export, the training and eval CLIs, the modality zoo and the
tile-rate study once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels compiled from ``kosmosx_torch/csrc`` for sm_90a,
   with ptxas's register, spill and wgmma-serialization lines; every
   instantiation of the Hopper kernels (the bf16 forward, dK/dV and dQ, the
   tile-rate kernel at d 64 and 128, the bf16 W8 kernel's decode and
   prefill blocks) with its SASS holding wgmma (HGMMA) and TMA loads
   (UTMALDG), and of the decode kernel with its SASS holding the bulk copy
   (UBLKCP), each with no spill and no "Potential Performance Loss" line;
3. the flash-attention kernel against its plain PyTorch version at the
   flagship's attention shape (2, 32, 2048, 64): causal with fused xPos,
   causal with xPos and one segment id everywhere (the training batches),
   causal with ragged padding segments, non-causal, in bf16 (bar 2e-2) and
   fp32 (bar 1e-4, TF32 off); the (l, m) statistics against the plain
   version's too; in bf16 the rotation kernel's q' and k' bit-identical to
   the plain version's, and the rotation and the kernel timed alone;
4. the decode-attention kernel against its plain version: (8, 32, 1, 64)
   queries over a (8, 32, 2048, 64) cache with ragged kv_len, and the
   generation's decode shape, (4, 32, 1, 64) over a (4, 32, 544, 64) cache
   at kv_len (272, 336, 400, 528) (phase 6's requests half-way through their
   new tokens); bf16 (bar 2e-2) and int8 codes with scales (bar 5e-2), each
   also within 1e-2 of every output row's magnitude, and both again with an
   fp32 query (bar 1e-5); two launches bit-identical; device times from
   CUDA graphs (a launch is about as long as its host call), beside
   back-to-back launch times;
4a. the tile-rate kernel (S = Q K^T rounded to bf16, O = S V) against its
   plain version at (4, 1024, 64), (4, 1024, 128) and the study's three
   shapes (256, 1024, 64), (128, 1024, 128) and (256, 1024, 128), bar 1e-2
   of the largest reference value, two launches bit-identical, and at the
   study's shapes no slower than the ``torch.bmm`` pair; then
   the tile-rate study (kosmosx_torch/studies/tile_rate_study.py): its three
   configurations, kernel and ``torch.bmm`` pair, the FLOP-matched d64 /
   d128 time ratio and the verdict;
4b. the LayerNorm kernels (forward, backward) against their plain versions
   on bf16 rows at the main path's shapes: with fp32 parameters
   (training), the decoder's (8184, 2048) and (8184, 8192), the ViT's and
   the resampler media's (1028, 1024) and the resampler latents' (256,
   1024); with bf16 ones (scoring, serving), (12276, 2048), (12276, 8192),
   (1542, 1024), (384, 1024) and a decode step's (128, 2048): outputs
   within one bf16 ulp, dx within 1e-2 and fp32 parameter gradients within
   1e-3 of their largest values (bf16 ones within one ulp), two backward
   runs bit-identical, one launch a call; each direction timed beside its bound, its plain version,
   the plain chain under autograd (forward and backward, what a LayerNorm
   cost before the kernels) and ``F.layer_norm`` (a yardstick the port
   never calls);
4c. the LFM2 cell's kernels at its shapes (``phase_lfm2``): the short conv
   at (32768, 2048), RMSNorm at (32768, 2048) and (32768 x 40, 64), QK-norm
   and RoPE at (32768, 48 heads, 64), the GQA flash forward at (4, 32/8,
   8192, 64) against plain attention in blocks of query rows, the experts'
   grouped products at 131,072 rows over 64 experts under a Zipf load, the
   routing and the combine; each against its plain version, one launch a
   call, timed beside its bound;
4d. LFM2-24B-A2B's forward on the main path (``phase_lfm2_forward``):
   ``Lfm2.apply`` at the cell's weights and shape, every launch counter at
   0 just before it, the launches of each kernel counted;
4e. Lion in three launches (``phase_lion``) at the training cell's leaf
   set (the flagship's trainable fp32 leaves, CLIP frozen, the multiway B
   experts without gradients): three ``Optimizer.step`` calls on the
   kernels, p and m bit-identical to the leaf path's given the kernels'
   norm, three launches a step, the norm within 1e-6 of a float64 norm;
   the step timed beside its bound and the leaf path (device and host),
   and the launches a step of every optimizer kind;
5. the flagship ``Kosmos.apply`` in bf16 at 2 x (1920 text + 64 image)
   positions from a seeded random init: finite logits of the right shape, the
   flash kernel and its rotation kernel launched once per layer; and, on a
   depth-cut fp32 copy at full width, the
   kernel path against the plain-attention path (bar 1e-3);
6. greedy ``generate_multimodal`` with ``decode_attn_kernel=True``: 4 requests
   of one 224x224 image and 192/256/320/448 text tokens, 32 new tokens each;
   ids in the vocabulary, two runs identical, both kernels launched;
6e. raw inputs and an int8 KV cache: 4 uint8 images of 480x640, 300x400,
   224x299 and 640x480 through ``KosmosTokenizer.tokenize_images`` on the
   card against the CPU (bar 1e-4), 4 texts through ``tokenize_texts``
   (spliced lengths 192-448), then phase 6's request shape with
   ``kv_cache_dtype="int8"``: ids in the vocabulary, two runs identical, the
   decode kernel 24 x 31 times on the int8 caches, one decode step's logits
   through the kernel against plain attention on copies of the same caches
   (relative Frobenius error at most 2e-2), the int8 cache at most 0.55 of a
   bf16 cache's bytes; token agreement with a bf16 cache reported;
6f. a rolling window: ``generate_text`` on the flagship decoder with
   ``kv_window=512, kv_sink=4``, 4 prompts of 224-256 tokens, 352 new tokens
   (every row's writes wrap by 63 slots or more): a 512-position cache, ids
   in the vocabulary, two runs identical, the decode kernel at every step;
   at the step after the last, the kernel against plain attention and the
   caches re-centered by 4096 positions (``recenter_caches`` with
   ``xpos_center`` moved as much) against the step without, each at most
   2e-2;
6g. ``beam_search_multimodal`` (beam 4, 16 new tokens) on 2 of phase 6's
   requests: ids in the vocabulary, scores finite and sorted, two runs
   identical, the decode kernel at every step; greedy
   ``speculative_generate`` (gamma 4, 48 new tokens, a 2-layer draft of the
   flagship width) on 4 prompts: ids in the vocabulary, two runs identical,
   the acceptance rate and agreement with ``generate_text`` reported;
6h. the generation CLI (``kosmosx_torch.scripts.generate``) in this
   process at full width: ``--model kosmos --image <a uint8 .npy> --greedy
   --max-new-tokens 8``, then with ``--beam-size 2``: exit 0 and 8 ids;
6i. the serving engine at full width, bf16: phase 5's flagship with
   ``decode_attn_kernel=True`` under ``ServeEngine(max_batch=8,
   max_prompt_len=512, max_len=1024, sync_lag=4)``, 16 requests (4
   multimodal of phase 6, 12 text of 64-480 tokens from the seed, budgets
   of 32-64, no EOS; 8 text at once, the rest as slots free; one sampled at
   temperature 0.8 and top-k 50, one cancelled after 8 tokens, one a hit
   on a registered copy prefix of 128 tokens): every request done with its
   budget of ids in the vocabulary (the cancelled one fewer), the decode
   kernel once per layer and decode dispatch, the flash forward once per
   layer and admission prefill of 256 or more positions, peak memory below
   the card's; TTFT, inter-token p50/p99, tok/s, the host loop's phases
   and peak memory reported;
6j. the engine's exactness on the card: a full-width fp32 Kosmos cut to 2
   decoder and 2 ViT layers, the decode kernel on: 8 text requests on a
   text engine and 2 multimodal ones on a Kosmos engine beside
   ``generate_text``/``generate_multimodal``, then the text requests with
   ``spec_gamma=4`` and phase 6g's 2-layer draft, a shared-prefix run (no
   decode-kernel launch: plain attention serves a shared segment) and a
   2-adapter multi-LoRA run: greedy tokens identical, or at the first
   divergence a top-2 logit gap of the reference below 1e-4 (an fp32
   near-tie); one decode step over a staggered pool, kernel against plain
   attention, within 1e-4 of the largest logit;
6l. ``ServeServer`` on 127.0.0.1 over 6j's text engine: ``/healthz``,
   ``/v1/stats`` and 4 concurrent completions (2 streaming), whose tokens
   are 6j's engine tokens (near-ties as in 6j); the serving CLI
   (``kosmosx_torch.scripts.serve``) in this process at full width with
   two prompts and 8 new tokens, plain and ``--w8``: exit 0;
6a. the W8 kernels (``w8_matmul``, ``w8_matmul_stacked``) against their
   plain version at decode M 4 and 8 over (2048, 2048), (2048, 8192),
   (8192, 2048) and the vocab head's (2048, 32002), prefill M 3968 over
   (2048, 8192) and the vocab head, the ViT's (514, 1024, 4096), the ragged
   (5, 130, 70) and (514, 588, 1024), and a (24, 2048, 8192) stack at
   layers 0, 11 and 23 with M 4 and 3968 (codes as ``_quantize_w`` makes
   them: the vocab head's rows 32016 codes apart, on the Hopper kernel);
   the vocab head at M 4 and 3968 on dense codes too, which take the
   mma.sync kernel; fp32 (TF32 off, bar 1e-5) and bf16 (bar 1e-2: the
   plain version rounds twice, the kernels once), relative to the
   reference's largest value, two launches bit-identical; each call's
   kernel (the Hopper kernel, the mma.sync one or the fp32 one) logged and
   held to the shape rule ``quant_matmul._w8_plan``; device times from CUDA
   graphs, beside back-to-back launch times; and decode over all 24 layers
   of the stack in turn in one graph (L2-cold) beside layer 11 alone;
6b. the W8 reference: a depth-cut fp32 Kosmos as in phase 5, quantized in the
   stacked layout, logits through the W8 kernels against
   ``set_w8_kernel("off")`` (bar 1e-3);
6c. the flagship W8 ``Kosmos.apply`` (phase 5's bf16 model quantized, the
   decoder stacked) at 2 x 1984 positions: finite logits, both W8 kernels
   and 24 flash launches per run, every vocab-head call on the Hopper
   kernel (each such call's kernel read from ``quant_matmul._launch``),
   relative Frobenius error against the bf16 logits below 0.1,
   parameter bytes below 0.6 of the bf16 model's;
6d. phase 6's requests on the W8 model: ids in the vocabulary, two runs
   identical, the attention kernels and every W8 path launched (the 2-D
   wrapper's Hopper kernel, the vocab head's calls among them, and its
   mma.sync kernel for the patch embedding; every stacked call on the
   Hopper kernel), times and peak memory beside phase 6's;
6k. phase 6c's W8 model under the engine (6i's configuration, 8 text
   requests, 48 new tokens): both W8 wrappers' Hopper kernels launched,
   every vocab-head call on the Hopper kernel, ids in the vocabulary; tok/s
   and peak memory beside 6i's;
7. the flash backward kernels against their plain versions on the same
   (o, l, m) at (2, 32, 2048, 64), the three cases of phase 3 in bf16 and
   fp32: the pre-pass (q' and k' bit-identical, di within 1e-5 of its
   largest value), then dK/dV and dQ on its outputs, bf16 bar 1e-2 (P and
   dS round to bf16 as operands, and the readings on an H100 reached
   6.0e-3) and fp32 bar 1e-4 (TF32 off), both relative to each gradient's
   largest reference value; the whole backward run again bit-identical;
   each kernel timed alone and the three together beside the library
   call;
8. the gradient reference: a full-width fp32 Kosmos cut to 2 decoder and 2
   ViT layers, one train step's loss and gradients (CLIP frozen) through
   the kernels with remat "dots" against the plain-attention path (bar 1e-3
   of each gradient's largest value);
9. the flagship training recipe of benchmarks/mm_train_probe.py: full
   Kosmos from a seeded init with fp32 parameters and bf16 compute, remat
   "dots", CLIP frozen, Lion, 8 steps of ``Trainer.run`` on one batch of
   2 x (1984 text + 64 image) positions: finite losses and gradient norms,
   the loss of step 8 below that of step 2, CLIP bit-identical, the
   pre-pass, dK/dV and dQ each launched once per layer and step, the
   forward's rotation kernel once per forward launch, the Lion kernels
   three times a step over every trainable leaf.
8b. dropout under remat: phase 8's depth-cut fp32 Kosmos with dropout 0.1
   on a CUDA generator: with attention dropout 0.1 (plain attention, no
   flash launch) remat "dots" against remat off, and with attention
   dropout 0 (flash on) "nothing", "dots" and "dots_no_batch" against
   remat off: every gradient within 1e-5 of its largest value;
9b. phase 9's recipe on real-format data: AdamW8bit, ``grad_accum=2``,
   remat "dots_no_batch", dropout 0.1 with attention dropout 0 (flash
   on), batches from ``image_caption_batches`` over 8 ``.npy`` 224²
   images and a ``captions.jsonl`` of ~2,000-character captions written
   from the seed, 2 x 1984 text positions, 8 micro-steps (4 updates):
   finite losses and gradient norms, sampled parameters changed at
   micro-steps 2, 4, 6 and 8 only, the mean loss of 7-8 below that of
   1-2, CLIP bit-identical, the pre-pass, dK/dV and dQ 24 x 8 times, the
   moment bytes within 1% of 2 x trainable x (1 + 4/256); step time,
   tokens/s, peak memory and one optimizer step's time and launches
   reported;
9c. examples/train_flagship_1chip.py's recipe: the text decoder with bf16
   parameters, Lion8bit, remat "dots", flash, 6 steps at 2 x 2048 on one
   repeated batch: finite losses, the last below the first; moment bytes
   against P x (1 + 4/256), peak memory and the loss on a fresh batch it
   does not train on, before and after, reported;
9d. the training and eval CLIs at full width and 4 layers, in one child
   process on the card with the 2-layer runs below (this script's ``--cli
   NAME ARGV --then ...`` runs each CLI's ``main`` in turn and reports):
   ``kosmosx_torch.scripts.train`` on a text file written from the
   seed, lion8bit, ``--grad-accum 2``, remat, dropout at its defaults, 4
   steps and a checkpoint: exit 0, 4 JSONL records, the native packing
   library loaded; ``kosmosx_torch.scripts.eval`` on that checkpoint: a
   finite perplexity, the flash forward 4 times per batch; at 2 layers,
   4 steps in one process against 2, then ``--resume`` for 2 in another
   (``python -m``): losses within 1e-3 relative; at 2 layers too,
   ``--lora-rank 4`` exits 0 and writes ``{output-dir}/adapter``, the
   serving CLI with ``--adapter a=<it> --use-adapter a`` exits 0, and
   ``--dpo prefs.jsonl --lora-rank 4`` exits 0;
10a. the W8 product under autograd: dx through ``w8_matmul`` (M 4 and
   3968 over (2048, 8192) and over the vocab head's codes at their padded
   pitch) and ``w8_matmul_stacked`` (layer 11 of (24, 2048, 8192)) against
   ``torch.autograd.grad`` of ``w8_matmul_plain``, bf16 (bar 1e-2) and
   fp32 (bar 1e-5, TF32 off), relative to the reference's largest value:
   outputs with a grad_fn, two backward runs bit-identical;
10b. the LoRA gradient reference: phase 8's depth-cut fp32 Kosmos
   quantized W8 (stacked), LoRA rank 8 on the default targets: one
   ``make_lora_train_step``'s loss and factor gradients through the W8 and
   flash kernels (remat "dots") against ``set_w8_kernel("off")`` and plain
   attention (bar 1e-3 of each gradient's largest value; a 0-d scale's
   against the sum of its terms), the base bit-identical after the step;
   the same on the unquantized base in bf16;
10c. LoRA at full width: phase 9's recipe as ``LoraTrainer`` at rank 16
   (AdamW, lr 1e-3), 8 steps: finite losses, step 8's below step 2's,
   every base tensor bit-identical, optimizer state 2 x the factors'
   bytes, the pre-pass, dK/dV and dQ 24 per step and the forward 48; step
   time, tokens/s and peak memory beside phase 9's;
10d. QLoRA at full width: phase 6c's W8 flagship (decoder stacked) under
   10c's recipe: 10c's checks, the codes and scales among the base
   tensors, both W8 wrappers on their Hopper kernels, every vocab-head
   call on the Hopper kernel; peak memory beside 10c's;
10e. DPO at full width: phase 9c's model (bf16 parameters) with LoRA rank
   16, the frozen base as reference, 8 preference rows written from the
   seed read at length 512 through ``preference_jsonl_batches``, batch 4,
   4 steps, beta 0.1, dropout 0: the first loss ln 2 within 1e-3, the
   metrics finite, the flash forward 24 times per sequence in
   ``compute_ref_logprobs``.
Run after 6g, on its model:
10f. distillation: ``distill_draft`` of a 2-layer draft at the flagship
   width from 6g's decoder, 100 steps of 8 x 256 synthetic tokens, lr
   1e-3: the loss falls and the teacher agreement rises from the fresh
   draft's; 6g's greedy ``speculative_generate`` (gamma 4) with the
   distilled draft, its acceptance beside 6g's random draft's; and on an
   fp32 copy of the teacher its tokens are ``generate_text``'s, or differ
   first at an fp32 near-tie below 1e-4 (phase 6j's rule; in bf16 a
   chunked verify and one-token steps part at near-ties of a random
   model, and 6g reports that agreement).

Run after 5, on its model:
11g. phase 5's bf16 flagship through ``state_dict_from_kosmos_params`` ->
   ``kosmos_params_from_state_dict`` (the reference's ``final_model.pt``
   layout) in memory on the card: the re-imported model's logits
   bit-identical to the model's on 2 x (1920 + 64) positions.
Run after 10e, the mixture-of-experts decoder of benchmarks/moe_bench.py
(24 layers, 2048 wide, 4 experts of ffn 8192, top-2, capacity 1.25,
multiway off, bf16 compute, from a seeded generator on the card):
11a. ``moe_ffn`` at (4, 2048, 2048) against ``moe_ffn_dense_oracle`` at
   capacity E: bf16 (bar 2e-2 of the largest output) and fp32 (TF32 off,
   bar 1e-4); the kept share at capacity 1.25 and its time beside the
   dense FFN's of ffn 8192 and 16384;
11b. the MoE ``decoder_forward(with_aux=True)`` at 4 x 2048: finite
   logits, aux > 0, the flash forward and its rotation 24 times each; wall
   time, device time and peak memory beside the dense decoder of the same
   width and the active-width one (ffn 16384); a 2-layer fp32 copy at full
   width, kernel path against plain attention (bar 1e-3, routing
   identical);
11c. greedy ``generate_text`` with ``decode_attn_kernel=True``: 4 prompts of
   192-448 tokens, 32 new tokens: ids in the vocabulary, two runs
   identical, the flash forward 24 times and the decode kernel 24 x 31;
11d. ``ServeEngine`` on the MoE decoder, 6i's configuration with 16 text
   requests: every request done, the kernels' launches as in 6i; TTFT,
   inter-token p50/p99, tok/s, peak memory; on a 2-layer fp32 copy at full
   width, the engine's greedy tokens for padded prompts of 5 lengths equal
   ``generate_text`` on the unpadded ones (6j's near-tie rule);
11e. ``Trainer.run`` with ``lm_loss_fn``: 2 x 2048, fp32 parameters, bf16
   compute, Lion, remat "dots", 8 steps on one batch: finite losses, step
   8's below step 2's, ``moe_aux`` in every step's metrics, the flash
   forward 48 and dK/dV and dQ 24 times a step, every expert of layers 0
   and 23 with nonzero fc1 and fc2 gradients at step 1; step time, tokens/s,
   peak memory and the model-FLOPs share of the kept tokens' work;
11f. the CLIs in one child process: the training CLI with ``--moe-experts 4
   --layers 2`` at full width (exit 0, ``moe_aux`` logged); a reference
   ``final_model.pt`` of a seeded full-width Kosmos cut to 2 decoder and 2
   ViT layers through ``kosmosx_torch.scripts.import_reference`` (exit 0,
   parameters identical), then ``--model kosmos --init-checkpoint`` on its
   output (exit 0).
Run after 11f, the modality zoo on the flagship decoder (bf16 compute over
fp32 parameters), the towers at their default, fp32 (TF32 off):
12a. ``KosmosConditional`` with ViT-L/14 and the resampler, wav2vec2-base
   and r3d18: 2 rows of 1024 text tokens (one right-padded), 16,000 audio
   samples and (2, 3, 16, 112, 112) clips: logits (2, 1090, 32002) finite,
   text-only logits too, the flash forward and its rotation 24 times in
   ``apply``; device time of each tower, the decoder and ``apply``, peak
   memory; the decoder in fp32, kernel path against plain attention at
   full depth (bar 1e-3);
12b. the framed audio and lean video towers on 12a's decoder: logits
   finite, device time per tower;
12c. ``KosmosAny`` on 12a's decoder: the unified trunk with flash on (an
   image of 257 tokens, 204,400 audio samples: 512 tokens and the
   non-causal flash kernel in all 6 layers, a clip of 393, an "any"
   array), each against the plain trunk (bar 1e-3), ``apply`` with 30
   flash launches; per-modality towers registered through
   ``prepare_media`` and the detector, every leaf on the card;
12d. the gradient of the mean cross-entropy over 12a's text positions,
   CLIP frozen: finite and non-zero in the projections, wav2vec2, r3d18,
   the resampler and decoder layers 0 and 23; the backward's pre-pass,
   dK/dV and dQ 24 times; peak memory; in fp32, kernel path against plain
   (bar 1e-3 of each gradient's largest value);
12e. an r3d_18 oracle with torchvision's layout at its real widths and
   random BatchNorm statistics, converted by
   ``r3d18_params_from_state_dict`` on the card: the encoder within 2e-4
   of the oracle in fp32, both timed;
13a. context parallelism in 2 child processes on the card (``--rank
   ring,sp``, which run 13b's task next; gloo, since NCCL refuses two ranks on one device: the K/V
   transport is staged through host memory and its time is not the
   card's links): ``ring_flash_attention`` and
   ``zigzag_ring_flash_attention``, causal, with and without packed
   segment ids, forward and backward on each rank's shard: bf16 at 32
   heads x 16384 positions (2 x 8192) against the flash kernels on the
   whole sequence (output 2e-2, gradients 1e-2 of their largest value),
   fp32 at 2 x 1024 against the plain versions (1e-3); each rank's
   forward, dK/dV and dQ launches (one pre-pass per ring backward) and
   the kernels' device time apart from the transport: in the ring
   (``torch.profiler``; the two ranks' kernels share the card) and each
   rank's pair calls timed alone (CUDA events) while the other waits;
13b. the sequence-parallel step (``make_seq_parallel_train_step``) at the
   flagship's widths cut to 2 layers, one row of 8192 positions over 2
   ranks, both schedules, bf16 compute over fp32 parameters, SGD: the
   ranks' losses and updated parameters identical, within 1e-2 (loss)
   and 5e-2 (each leaf's gradient, of its largest value) of one
   process's step on the whole sequence; launches, step time and each
   rank's peak memory;
13c. the training CLI at full width, ``--distributed --data 2 --layers
   2``, in 2 child processes under torchrun's variables: exit 0 on both,
   the same final losses, rank 0 alone writing the checkpoint and the
   metrics;
14a. tensor parallelism in 2 child processes on the card (``--rank
   tp_train,ep,pp,tp_serve,tp_w8``: 14a-14e's tasks in turn, gloo as in
   13a): ``Trainer`` over tensor=2 on the flagship
   decoder at full width and depth (16 heads and 4096 FFN columns a
   rank), bf16 compute, fp32 parameters, Lion, remat "dots", 3 steps at 2
   x 2048: the ranks' losses identical, step 1's loss and gradient norm
   within 1e-2 of one process's and sampled leaves' whole gradients
   within 5e-2 of their largest value; the flash kernels per rank; step
   time, peak memory and the rank's state bytes;
14b. ``ServeEngine(mesh=)`` at tensor=2 (``--rank tp_serve``): the bf16
   flagship decoder at full width, its depth cut to 8 layers, over 16
   text requests of 6i's lengths and budgets on 8 slots (8 of them
   admitted into freed slots): the ranks' tokens identical, the decode kernel once per layer
   and dispatch on each rank, the pool half of one process's, the first
   decode step's logits within 5e-2 of one process's; TTFT, inter-token
   p50/p99, tok/s; a 2-layer fp32 copy's greedy tokens those of the
   one-process engine (or an fp32 near-tie);
14c. the expert axis at expert=2 (``--rank ep``): 11b's MoE forward (2 of
   4 experts a rank) at 4 x 2048 in bf16 against one process's (every
   position's logits within 5e-2 of the largest, routing loss 1e-3
   relative),
   and one ``Trainer`` step of its 4-layer cut
   at 2 x 2048 with the routing loss (loss, routing loss and gradient
   norm 1e-2, sampled gradients 5e-2); the experts' bytes a rank;
14d. the pipeline at pipe=2 (``--rank pp``): two GPipe and two 1F1B SGD
   steps on the flagship decoder at full width and depth, 12 layers a
   stage, 4 microbatches of 1 x 2048, bf16 compute: the ranks' losses
   identical and step 1's within 1e-2 of one process's, its sampled
   gradients within
   5e-2; ticks, each rank's step time and peak memory (1F1B's stash
   beside GPipe's graphs);
14e. W8 weights and multi-LoRA adapters over tensor=2 (``--rank tp_w8``):
   6k's W8 flagship (full width and depth, stacked codes) under
   ``ServeEngine(mesh=)`` over 6k's 8 requests: the ranks' tokens
   identical, each rank's codes cut to (24, 2048, 1024), (24, 1024, 2048),
   (24, 2048, 4096) and (24, 4096, 2048), each on the Hopper W8 kernel by
   the shape rule, every decode dispatch 144 stacked launches and one
   vocab-head launch, all Hopper, the first decode step's logits within
   5e-2 of the one-process W8 model's; TTFT, inter-token p50/p99, tok/s;
   two rank-16 adapters on 8 text requests of a 2-layer fp32 copy, the
   one-process engine's tokens (or an fp32 near-tie); two QLoRA steps on
   a 4-layer W8 cut at full width (2 x 2048, bf16 compute): step 1's loss
   within 1e-2 of one process's, sampled factor gradients within 5e-2 of
   their largest value, the W8 and flash launches a rank; then the W8
   kernels alone at a rank's decode shapes (M = 8 over each cut stack and
   the whole vocab head) beside their bounds.

Phases 3, 4, 6a and 7 also time each kernel's library yardstick, one
PyTorch call that computes the same function, after holding its result
against the plain version: PyTorch's causal flash-attention forward and
backward on xPos-rotated q and k (the rotation left out), SDPA with a
boolean ``kv_len`` mask, ``torch._weight_int8pack_mm``; the port never
calls them.

Every failed check raises. Before the last line it prints the run's wall
time, then one JSON object
with each kernel's launches in its slice's run (generation for the forward
and decode kernels, the decode kernel's in phases 6e-6g, 6i-6k, 11c and
11d beside them, W8
generation for the W8 kernels, training for the backward kernels and the
forward's rotation, which the generation prefill does not run, the flash
kernels' in phases 9-10e, 11b-11e, 12a, 12c, 12d, 13a, 13b, 14a, 14c,
14d and 14e beside them (the ranks' summed), the decode kernel's in 14b
and 14e too, the W8 kernels' in 10d and 14e, the
study
for the tile-rate kernel), its error, its time,
the plain version's, its bound (``kosmosx_torch/ops/roofline.py``) and its
yardstick's, then the card's ``nvidia-smi`` line; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from kosmosx_torch.utils.timing import cuda_ms, graph_ms

SEED = 0
FLASH_SHAPE = (2, 32, 2048, 64)
DECODE_B, DECODE_S = 8, 2048
DECODE_KV_LEN = (2048, 1999, 1500, 1024, 777, 512, 100, 1)
# generation's decode: 4 requests of 64 image + 192-448 text positions and
# 32 new tokens (a 544-position cache), half-way through the new tokens
GEN_DECODE_B, GEN_DECODE_S = 4, 544
GEN_DECODE_KV_LEN = (272, 336, 400, 528)


_T0 = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One JSON line for ``phase``, with ``t``, the seconds since the
    script started (where the time goes, phase by phase)."""
    print(json.dumps({"phase": phase, **fields,
                      "t": time.perf_counter() - _T0}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def library_time(make, ref, bar, pick=lambda out: out, timer=None) -> dict:
    """A kernel's yardstick: the time of one PyTorch call that computes the
    kernel's function. ``make()`` prepares what the call needs, untimed, and
    returns the call; its result (``pick(call())``) is held against the
    plain version's ``ref`` (error relative to its largest value below
    ``bar``). ``library_ms`` is None, with the reason, where this torch has
    no such call on the card or its result disagrees. The port never calls
    it."""
    try:
        fn = make()
        out = pick(fn())
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        if err >= bar:
            return {"library_ms": None, "library_rel_err": err,
                    "library_note": f"disagrees with the plain version: "
                                    f"{err} >= {bar}"}
        return {"library_ms": (timer or cuda_ms)(fn), "library_rel_err": err}
    except (RuntimeError, NotImplementedError) as e:
        return {"library_ms": None,
                "library_note": str(e).splitlines()[0][:200]}


# what each Hopper kernel's SASS must hold: wgmma (HGMMA) and TMA tile loads
# (UTMALDG), or for the decode kernel the 1-D bulk copy (UBLKCP)
SASS_REQUIRED = {
    **dict.fromkeys(("flash_fwd_hopper_kernel", "flash_bwd_dkv_hopper_kernel",
                     "flash_bwd_dq_hopper_kernel", "tile_rate_hopper_kernel",
                     "w8_bf16_hopper_kernel"), ("HGMMA", "UTMALDG")),
    "decode_split_kernel": ("UBLKCP",)}
HOPPER_KERNELS = tuple(SASS_REQUIRED)
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "WARPGROUP.DEPBAR")


def hopper_instance(line: str):
    """The ``HOPPER_KERNELS`` kernel a ptxas or SASS line names, with the
    mangled template arguments of its instantiation (``ILi64EE``), or None."""
    for name in HOPPER_KERNELS:
        at = line.find(name)
        if at >= 0:
            args = re.match(r"(I\w*?E)Ev", line[at + len(name):])
            return name + (args[1] if args else "")
    return None


def ptxas_report(lines) -> dict:
    """Per instantiation of a kernel of ``HOPPER_KERNELS``, from nvcc's
    ``-Xptxas -v`` log: its registers, its spilled bytes (stores and loads)
    and ptxas's "Potential Performance Loss" lines (a serialized wgmma), each
    line taken for the kernel it names or else for the kernel being
    compiled."""
    report, current = {}, None
    for line in lines:
        named = hopper_instance(line)
        if "Compiling entry function" in line or "Function properties for" in line:
            current = named
            if named:
                report.setdefault(named, {"registers": None, "spill_bytes": 0,
                                          "performance_loss": []})
            continue
        kernel = named or current
        if kernel is None:
            continue
        if "Performance Loss" in line:
            report[kernel]["performance_loss"].append(line.strip())
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            report[kernel]["spill_bytes"] += int(spill[1]) + int(spill[2])
        used = re.search(r"Used (\d+) registers", line)
        if used:
            report[kernel]["registers"] = int(used[1])
    return report


def sass_counts(build) -> dict:
    """Per instantiation of a kernel of ``HOPPER_KERNELS``, how often its
    SASS in the built library holds a warpgroup product (HGMMA), a TMA load
    (UTMALDG), a bulk copy (UBLKCP) and a wait for products
    (WARPGROUP.DEPBAR; one per HGMMA means ptxas serialized them), from
    ``cuobjdump -sass`` beside nvcc, and which uniform-datapath bulk or TMA
    opcodes it holds (``bulk_ops``, to name them where a check fails)."""
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    lib = build.build_dir() / build.LIB_NAME
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            current = hopper_instance(line)
            if current:
                counts[current] = dict.fromkeys(SASS_OPS, 0)
                counts[current]["bulk_ops"] = set()
        elif current:
            for op in SASS_OPS:
                counts[current][op] += op in line
            counts[current]["bulk_ops"].update(
                re.findall(r"\b(UBLK\w*|UTMA\w*)", line))
    for ops in counts.values():
        ops["bulk_ops"] = sorted(ops["bulk_ops"])
    return counts


def phase_flash(dev, fa):
    b, h, l, d = FLASH_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED)
    base = [torch.randn(FLASH_SHAPE, generator=g, device=dev) for _ in range(3)]
    seg = (torch.arange(l, device=dev)[None] <
           torch.tensor([l, 1500], device=dev)[:, None]).int() - 1
    one_id = torch.zeros(b, l, dtype=torch.int32, device=dev)
    cases = {
        "causal_xpos": dict(causal=True, xpos_scale_base=512),
        "causal_xpos_uniform": dict(causal=True, xpos_scale_base=512,
                                    q_segment_ids=one_id,
                                    kv_segment_ids=one_id),
        "causal_padding": dict(causal=True, q_segment_ids=seg,
                               kv_segment_ids=seg),
        "non_causal": dict(causal=False),
    }
    results = {}
    for dtype, bar in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, k, v = (t.to(dtype) for t in base)
        for name, kw in cases.items():
            kw = dict(kw, sm_scale=d ** -0.5)
            o, stat_l, m = fa.flash_attention_fwd(q, k, v, **kw)
            o_ref, l_ref, m_ref = fa.flash_attention_plain(
                q, k, v, xpos_center=l // 2, **kw)
            torch.cuda.synchronize()
            err = max_err(o, o_ref)
            # the (l, m) statistics the backward and ring attention consume
            stats_ok = (torch.allclose(m, m_ref, atol=1e-3, rtol=1e-4)
                        and torch.allclose(stat_l, l_ref, atol=1e-3, rtol=1e-3))
            ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw))
            plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
                q, k, v, xpos_center=l // 2, **kw), iters=3)
            key = f"{name}_{str(dtype).split('.')[-1]}"
            r = results[key] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                m_max_abs_err=max_err(m, m_ref),
                l_max_rel_err=((stat_l - l_ref).abs()
                               / l_ref.abs().clamp_min(1e-30)).max().item())
            if dtype == torch.bfloat16:
                r.update(fwd_parts(fa, q, k, v, kw))
            if key == "causal_xpos_bfloat16":
                r.update(library_time(
                    lambda: functools.partial(sdpa_flash_fwd, *xpos_rotated(
                        fa, q, k), v, kw["sm_scale"]),
                    o_ref, bar, pick=lambda out: out[0]))
            log("flash", case=key, shape=list(FLASH_SHAPE), bar=bar,
                stats_bar="atol 1e-3, rtol 1e-4 (m) / 1e-3 (l)", **r)
            check(err < bar, f"flash {key} error {err} >= {bar}")
            check(stats_ok, f"flash {key} statistics (l, m) against the "
                            f"plain version")
            check(r.get("prep_bit_identical", True),
                  f"flash {key}: the rotation's q' or k' differs from the "
                  f"plain version")
            del o, o_ref, m, m_ref, stat_l, l_ref
    return results


def fwd_parts(fa, q, k, v, kw) -> dict:
    """The bf16 forward's two launches apart: the kernel alone on the q and
    k it streams (``kernel_ms``) and, with xPos, the rotation kernel that
    makes them (``prep_ms``, device time in a CUDA graph; its q' and k'
    against the plain version's, bit for bit) and the two together
    (``with_prep_ms``)."""
    rkw = fa._resolve(q, **kw)
    xpos = rkw["xpos_scale_base"] is not None
    q_r, k_r = fa.flash_fwd_prep(q, k, **kw)
    kernel = functools.partial(
        fa._fwd_kernel_cuda, q_r, k_r, v, causal=rkw["causal"],
        scale=1.0 if xpos else rkw["sm_scale"] * fa.LOG2E,
        q_segment_ids=rkw["q_segment_ids"],
        kv_segment_ids=rkw["kv_segment_ids"])
    out = {"kernel_ms": cuda_ms(kernel)}
    if xpos:
        ref_q, ref_k = fa.flash_fwd_prep_plain(q, k, **rkw)
        torch.cuda.synchronize()
        prep = functools.partial(fa.flash_fwd_prep, q, k, **kw)
        out.update(
            prep_bit_identical=torch.equal(q_r, ref_q) and torch.equal(k_r, ref_k),
            prep_max_abs_err=max(max_err(q_r, ref_q), max_err(k_r, ref_k)),
            # the rotation is shorter than its Python wrapper: back to
            # back, its launches would time the host; a CUDA graph leaves
            # it out (prep_launch_ms beside it)
            prep_ms=graph_ms(prep), prep_launch_ms=cuda_ms(prep),
            prep_plain_ms=cuda_ms(lambda: fa.flash_fwd_prep_plain(q, k, **rkw),
                                  iters=3))
        out["with_prep_ms"] = out["kernel_ms"] + out["prep_ms"]
    return out


def xpos_rotated(fa, q, k):
    """q and k rotated by the flash kernels' xPos (scale base 512, centred
    at L / 2), with no softmax scale folded in: the inputs of a library
    attention call, which has no xPos. The rotation is left out of its
    time."""
    l, d = q.shape[2], q.shape[3]
    q_sin, q_cos, k_sin, k_cos = fa._tables(l, l, d, 512, l // 2, 1.0, q.device)
    return fa._rotate(q, q_sin, q_cos), fa._rotate(k, k_sin, k_cos)


def sdpa_flash_fwd(q, k, v, scale):
    """PyTorch's causal flash-attention forward, which also returns the
    logsumexp: (o, logsumexp, ...)."""
    return torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, True, False, scale=scale)


def sdpa_flash_bwd(fa, q, k, v, do, scale):
    """PyTorch's causal flash-attention backward, dq, dk and dv in one call,
    on xPos-rotated q and k and the forward's o and logsumexp."""
    qr, kr = xpos_rotated(fa, q, k)
    o, lse, cq, ck, mq, mk, seed, offset = sdpa_flash_fwd(qr, kr, v, scale)[:8]
    return functools.partial(
        torch.ops.aten._scaled_dot_product_flash_attention_backward,
        do, qr, kr, v, o, lse, cq, ck, mq, mk, 0.0, True, seed, offset,
        scale=scale)


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest error relative to the reference's largest magnitude."""
    return max_err(a, ref) / max(ref.float().abs().max().item(), 1e-30)


def phase_flash_bwd(dev, fa):
    """The backward's three kernels against their plain versions on the same
    residuals: the pre-pass (q' and k' bit-identical, di within 1e-5 of its
    largest value), then dK/dV and dQ on the pre-pass's outputs, timed each
    alone and together as ``flash_attention_bwd`` runs them, whose second
    run must give the same bits."""
    b, h, l, d = FLASH_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    base = [torch.randn(FLASH_SHAPE, generator=g, device=dev) for _ in range(4)]
    seg = (torch.arange(l, device=dev)[None] <
           torch.tensor([l, 1500], device=dev)[:, None]).int() - 1
    cases = {
        "causal_xpos": dict(causal=True, xpos_scale_base=512, xpos_center=l // 2),
        "causal_padding": dict(causal=True, q_segment_ids=seg,
                               kv_segment_ids=seg),
        "non_causal": dict(causal=False),
    }
    results = {}
    for dtype, bar in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        q, k, v, do = (t.to(dtype) for t in base)
        for name, kw in cases.items():
            kw = dict(kw, sm_scale=d ** -0.5)
            rkw = fa._resolve(q, **kw)
            o, stat_l, m = fa.flash_attention_fwd(q, k, v, **kw)
            q_r, k_r, di = fa.flash_bwd_prep(q, k, o, do, **kw)
            ref_q, ref_k, ref_di = fa.flash_bwd_prep_plain(q, k, o, do, **kw)
            # what flash_attention_bwd launches: the bf16 kernels read q'
            # and k', the fp32 ones rotate raw q and k themselves
            rotate = dtype == torch.bfloat16
            prep = functools.partial(fa._prep_cuda, q, k, o, do, rotate=rotate,
                                     **rkw)
            rot = prep()[:2]
            args = (q, k, v, stat_l, m, di, do)
            dkv = functools.partial(fa._dkv_cuda, *args, rotated=rot, **rkw)
            dq_ = functools.partial(fa._dq_cuda, *args, rotated=rot, **rkw)
            dk, dv = dkv()
            dq = dq_()
            again = fa.flash_attention_bwd(q, k, v, o, stat_l, m, do, **kw)
            ref_dk, ref_dv = fa.flash_bwd_dkv_plain(*args, **kw)
            ref_dq = fa.flash_bwd_dq_plain(*args, **kw)
            torch.cuda.synchronize()
            prep_same = torch.equal(q_r, ref_q) and torch.equal(k_r, ref_k)
            di_err = rel_err(di, ref_di)
            errs = {n: (max_err(a, r), rel_err(a, r)) for n, a, r in
                    (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv))}
            same = all(torch.equal(a, b_) for a, b_ in zip((dq, dk, dv), again))
            key = f"{name}_{str(dtype).split('.')[-1]}"
            r = results[key] = dict(
                max_abs_err={n: e[0] for n, e in errs.items()},
                max_rel_err={n: e[1] for n, e in errs.items()},
                prep_max_abs_err=max(max_err(q_r, ref_q), max_err(k_r, ref_k),
                                     max_err(di, ref_di)),
                prep_bit_identical=prep_same, di_rel_err=di_err,
                prep_ms=cuda_ms(prep), dkv_ms=cuda_ms(dkv), dq_ms=cuda_ms(dq_),
                bwd_ms=cuda_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, o, stat_l, m, do, **kw)),
                prep_plain_ms=cuda_ms(lambda: fa.flash_bwd_prep_plain(
                    q, k, o, do, **kw), iters=3),
                dkv_plain_ms=cuda_ms(lambda: fa.flash_bwd_dkv_plain(*args, **kw),
                                     iters=3),
                dq_plain_ms=cuda_ms(lambda: fa.flash_bwd_dq_plain(*args, **kw),
                                    iters=3),
                bit_identical=same)
            r["sum_ms"] = r["prep_ms"] + r["dkv_ms"] + r["dq_ms"]
            if key == "causal_xpos_bfloat16":
                # the library call gives dq, dk and dv: its time stands
                # against the pre-pass, dK/dV and dQ together (sum_ms)
                r.update(library_time(
                    lambda: sdpa_flash_bwd(fa, q, k, v, do, kw["sm_scale"]),
                    ref_dv, bar, pick=lambda out: out[2]))
            log("flash_bwd", case=key, shape=list(FLASH_SHAPE), rel_bar=bar,
                di_rel_bar=1e-5, **r)
            check(prep_same, f"flash bwd {key}: pre-pass q' or k' differs from "
                             f"the plain version")
            check(di_err < 1e-5, f"flash bwd {key} di relative error {di_err} "
                                 f">= 1e-5")
            for n, (_, rel) in errs.items():
                check(rel < bar, f"flash bwd {key} {n} relative error {rel} "
                                 f">= {bar}")
            check(same, f"flash bwd {key}: two launches differ")
            del o, stat_l, m, di, dq, dk, dv, again, ref_dq, ref_dk, ref_dv
            del q_r, k_r, ref_q, ref_k, ref_di, rot, args, dkv, dq_, prep
    return results


def _quantize(x):
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def row_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest error of a (B, H, 1, hd) output row relative to the row's
    largest reference value: one bf16 step of that value is at most 2^-7."""
    ref = b.float().abs().amax(dim=-1)
    err = (a.float() - b.float()).abs().amax(dim=-1)
    return (err / torch.where(ref > 0, ref, 1.0)).max().item()


def phase_decode(dev, da):
    """At the kernels line's shape (keys "bf16", "int8", "fp32",
    "int8_fp32_q") and generation's (the same with "gen_"). Bars: the
    absolute ones of the kernel's contract (2e-2 bf16, 5e-2 int8), and two
    that catch a kernel that drops or repeats a few cache positions: 1e-2 of
    each output row's magnitude, and 1e-5 absolute with an fp32 query,
    where nothing rounds to bf16. Two launches must give the same bits (the
    chunks merge in a fixed order)."""
    results = {}
    for prefix, b, s_len, lens in (("", DECODE_B, DECODE_S, DECODE_KV_LEN),
                                   ("gen_", GEN_DECODE_B, GEN_DECODE_S,
                                    GEN_DECODE_KV_LEN)):
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        q = torch.randn(b, 32, 1, 64, generator=g, device=dev) * 64 ** -0.5
        k = torch.randn(b, 32, s_len, 64, generator=g, device=dev)
        v = torch.randn(b, 32, s_len, 64, generator=g, device=dev)
        kv_len = torch.tensor(lens, device=dev)
        (kq, ks), (vq, vs) = _quantize(k), _quantize(v)
        scales = dict(k_scale=ks, v_scale=vs)
        cases = {
            "bf16": ((q.bfloat16(), k.bfloat16(), v.bfloat16(), kv_len), {},
                     2e-2),
            "int8": ((q.bfloat16(), kq, vq, kv_len), scales, 5e-2),
            "fp32": ((q, k, v, kv_len), {}, 1e-5),
            "int8_fp32_q": ((q, kq, vq, kv_len), scales, 1e-5),
        }
        for name, (args, kw, bar) in cases.items():
            o = da.decode_attention(*args, **kw)
            again = da.decode_attention(*args, **kw)
            ref = da.decode_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err, rel = max_err(o, ref), row_rel_err(o, ref)
            same = torch.equal(o, again)
            kernel = functools.partial(da.decode_attention, *args, **kw)
            plain = functools.partial(da.decode_attention_plain, *args, **kw)
            r = results[prefix + name] = dict(
                max_abs_err=err, max_row_rel_err=rel, bit_identical=same,
                ms=graph_ms(kernel), plain_ms=graph_ms(plain),
                launch_ms=cuda_ms(kernel, 50), plain_launch_ms=cuda_ms(plain, 20))
            if name == "bf16":
                # SDPA with a boolean mask from kv_len; the int8 cache has none
                mask = (torch.arange(s_len, device=dev)[None]
                        < kv_len[:, None])[:, None, None, :]
                r.update(library_time(
                    lambda: functools.partial(
                        torch.nn.functional.scaled_dot_product_attention,
                        *args[:3], attn_mask=mask, scale=1.0),
                    ref, bar, timer=graph_ms))
            log("decode", case=prefix + name, q=[b, 32, 1, 64],
                cache=[b, 32, s_len, 64], kv_len=list(lens), bar=bar, row_rel_bar=1e-2, **r)
            check(err < bar, f"decode {prefix}{name} error {err} >= {bar}")
            check(rel < 1e-2, f"decode {prefix}{name} row-relative error "
                              f"{rel} >= 1e-2")
            check(same, f"decode {prefix}{name}: two launches differ")
            del o, again, ref
    return results


def flagship_config(kosmosx_torch):
    """The flagship KosmosConfig in bf16, dropout off."""
    c = kosmosx_torch.core.config
    return c.KosmosConfig(
        decoder=c.MagnetoConfig(compute_dtype="bfloat16", dropout=0.0,
                                attention_dropout=0.0),
        vision=c.VisionConfig(compute_dtype="bfloat16"),
        resampler=c.ResamplerConfig(compute_dtype="bfloat16"))


def pixels(n: int, g: torch.Generator, dev, size: int = 224) -> torch.Tensor:
    """CLIP-normalised random images."""
    from kosmosx_torch.nn.vision import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD

    raw = torch.rand(n, 3, size, size, generator=g, device=dev)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=dev)[None, :, None, None]
    std = torch.tensor(CLIP_IMAGE_STD, device=dev)[None, :, None, None]
    return (raw - mean) / std


def phase_forward(dev, kx, fa):
    from kosmosx_torch.models.kosmos import Kosmos

    cfg = flagship_config(kx)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    t0 = time.perf_counter()
    model = Kosmos(cfg, generator=g, device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(4, cfg.decoder.vocab_size, (2, 1920), generator=g,
                           device=dev)
    images = pixels(2, g, dev)
    runs = 3
    with torch.inference_mode():
        model.apply(tokens, images)  # warm-up
        torch.cuda.synchronize()
        fa.flash_attention.launches = fa.flash_fwd_prep.launches = 0
        fwd_s = []
        for _ in range(runs):
            t0 = time.perf_counter()
            logits = model.apply(tokens, images)
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
    launches = fa.flash_attention.launches
    prep_launches = fa.flash_fwd_prep.launches
    shape = tuple(logits.shape)
    finite = bool(torch.isfinite(logits).all())
    log("forward", params=n_params, init_s=init_s, forward_s=fwd_s,
        logits_shape=list(shape), finite=finite, flash_launches=launches,
        flash_fwd_prep_launches=prep_launches)
    check(shape == (2, 1984, cfg.decoder.vocab_size), f"logits shape {shape}")
    check(finite, "flagship logits are finite")
    check(launches == prep_launches == runs * cfg.decoder.layers,
          f"flash launches {launches}, rotation launches {prep_launches}")
    del logits
    return model, cfg


def phase_reference(dev, kx):
    """Full width, depth cut to 2 decoder and 2 ViT layers, fp32: the
    kernel path against the plain-attention path on the same weights."""
    from kosmosx_torch.models.kosmos import Kosmos

    c = kx.core.config
    cfg = c.KosmosConfig(
        decoder=c.MagnetoConfig(layers=2, dropout=0.0, attention_dropout=0.0),
        vision=c.VisionConfig(layers=2))
    plain = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, use_flash_attention=False))
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    model = Kosmos(cfg, generator=g, device=dev)
    tokens = torch.randint(4, cfg.decoder.vocab_size, (2, 448), generator=g,
                           device=dev)
    images = pixels(2, g, dev)
    with torch.inference_mode():
        out = model.apply(tokens, images)
        model.config = plain
        ref = model.apply(tokens, images)
    err = max_err(out, ref)
    log("reference", layers=2, dtype="float32", positions=512, max_abs_err=err,
        bar=1e-3)
    check(err < 1e-3, f"kernel vs plain path logits error {err}")


def phase_grad_reference(dev, kx, fa):
    """Full width, depth cut to 2 decoder and 2 ViT layers, fp32: one train
    step's loss and trainable gradients through the kernels (remat "dots")
    against the plain-attention path on the same weights and batch."""
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.train.trainer import kosmos_loss_fn, value_and_grad

    c = kx.core.config
    cfg = c.KosmosConfig(
        decoder=c.MagnetoConfig(layers=2, dropout=0.0, attention_dropout=0.0,
                                remat=True, remat_policy="dots"),
        vision=c.VisionConfig(layers=2))
    plain = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, use_flash_attention=False, remat=False))
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    model = Kosmos(cfg, generator=g, device=dev)
    tokens = torch.randint(4, cfg.decoder.vocab_size, (2, 448), generator=g,
                           device=dev)
    tokens[:, 0] = 0
    tokens[1, 400:] = cfg.decoder.padding_idx
    batch = {"text_tokens": tokens,
             "images": pixels(2, g, dev, cfg.vision.image_size)}
    kernels = (fa.flash_attention, fa.flash_bwd_prep, fa.flash_bwd_dkv,
               fa.flash_bwd_dq)
    counts = [fn.launches for fn in kernels]
    (loss, _), grads = value_and_grad(kosmos_loss_fn(cfg), model, batch,
                                      freeze=("clip",))
    launches = [fn.launches - n for fn, n in zip(kernels, counts)]
    model.config = plain
    (ref_loss, _), ref = value_and_grad(kosmos_loss_fn(plain), model, batch,
                                        freeze=("clip",))
    worst, worst_name = 0.0, None
    for name, gr in ref.items():
        if gr is None:
            check(grads[name] is None, f"{name}: gradient only on the kernel path")
            continue
        err = rel_err(grads[name], gr)
        if err > worst:
            worst, worst_name = err, name
    loss_err = abs(loss.item() - ref_loss.item())
    log("grad_reference", layers=2, dtype="float32", positions=512,
        loss=loss.item(), loss_abs_err=loss_err, max_rel_grad_err=worst,
        worst_param=worst_name, trainable=len(ref),
        with_grad=sum(gr is not None for gr in ref.values()),
        launches=dict(zip(("flash_fwd", "flash_bwd_prep", "flash_bwd_dkv",
                           "flash_bwd_dq"), launches)), bar=1e-3)
    check(loss_err < 1e-3 * max(1.0, abs(ref_loss.item())),
          f"kernel vs plain path loss {loss.item()} vs {ref_loss.item()}")
    check(worst < 1e-3, f"kernel vs plain path gradient {worst_name}: {worst}")
    check(launches[1] == launches[2] == launches[3] == 2 and launches[0] == 4,
          f"kernel launches in the reference step {launches}")


def train_config(kx):
    """The multimodal training recipe (benchmarks/mm_train_probe.py:48-65):
    full Kosmos, bf16 compute, remat "dots", dropout off, 8194 positions."""
    c = kx.core.config
    return c.KosmosConfig(
        decoder=c.MagnetoConfig(compute_dtype="bfloat16", dropout=0.0,
                                attention_dropout=0.0, max_positions=8194,
                                remat=True, remat_policy="dots",
                                use_flash_attention=True),
        vision=c.VisionConfig(compute_dtype="bfloat16"),
        resampler=c.ResamplerConfig(compute_dtype="bfloat16"))


TRAIN_STEPS = 8
TRAIN_TEXT = 1984


def train_batch(cfg):
    """The first batch of ``synthetic_multimodal_batches``, 2 x 1984 text
    tokens and 2 images: with 64 image positions, 2 x 2048 decoder
    positions."""
    from kosmosx_torch.train.data import synthetic_multimodal_batches

    return next(synthetic_multimodal_batches(
        batch_size=2, seq_len=TRAIN_TEXT, vocab_size=cfg.decoder.vocab_size,
        image_size=cfg.vision.image_size, seed=SEED))


def train_flops(model, cfg, tokens: int) -> dict:
    """Model FLOPs of one step: 6 x parameters x tokens for the trainable
    parameters (and for those a position runs through: the multiway B
    experts are trainable but no position reaches them), plus causal
    attention, 3 x (2 products x 2 flops x L^2/2 x d) per layer and row."""
    d = cfg.decoder
    trainable = sum(p.numel() for n, p in model.named_parameters()
                    if not n.startswith("clip"))
    experts_b = sum(p.numel() for n, p in model.named_parameters()
                    if ".B." in n)
    seq = tokens // 2
    attn = 3 * 2 * 2 * (seq * seq / 2) * d.embed_dim * d.layers * 2
    return {"trainable": trainable, "active": trainable - experts_b,
            "flops_trainable": 6 * trainable * tokens + attn,
            "flops_active": 6 * (trainable - experts_b) * tokens + attn}


def phase_train(dev, kx, fa):
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.ops.lion import lion
    from kosmosx_torch.train.trainer import TrainConfig, Trainer, kosmos_loss_fn

    cfg = train_config(kx)
    tcfg = TrainConfig(batch_size=2, seq_len=TRAIN_TEXT, learning_rate=1e-4,
                       optimizer="lion", schedule="constant", warmup_steps=1,
                       total_steps=TRAIN_STEPS, checkpoint_every=0, log_every=1,
                       freeze=("clip",), seed=SEED + 8)
    t0 = time.perf_counter()
    trainer = Trainer(lambda g: Kosmos(cfg, generator=g, device=dev),
                      kosmos_loss_fn(cfg), tcfg, device=dev)
    state = trainer.init_state()
    model = state["params"]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    clip0 = {n: p.detach().clone() for n, p in model.named_parameters()
             if n.startswith("clip")}
    batch = train_batch(cfg)
    logs, stamps = [], []

    def log_fn(step, m):
        stamps.append(time.perf_counter())  # float(metrics) synchronised
        logs.append(m)

    torch.cuda.reset_peak_memory_stats()
    kernels = flash_counters(fa)
    for fn in kernels.values():
        fn.launches = 0
    lion.launches = lion.leaves = 0
    t0 = time.perf_counter()
    trainer.run(itertools.repeat(batch, TRAIN_STEPS), log_fn=log_fn)
    launches = {name: fn.launches for name, fn in kernels.items()}
    lion_counts = {"launches": lion.launches, "leaves": lion.leaves}
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    mean_s = sum(step_s[2:]) / len(step_s[2:])
    tokens = 2 * (TRAIN_TEXT + cfg.image_embed_len)
    flops = train_flops(model, cfg, tokens)
    losses = [m["loss"] for m in logs]
    norms = [m["grad_norm"] for m in logs]
    clip_same = all(torch.equal(p, clip0[n]) for n, p in
                    model.named_parameters() if n.startswith("clip"))
    log("train", steps=TRAIN_STEPS, batch=[2, TRAIN_TEXT + cfg.image_embed_len],
        params=sum(p.numel() for p in model.parameters()),
        trainable=flops["trainable"], active=flops["active"], init_s=init_s,
        losses=losses, grad_norms=norms, step_s=step_s,
        step_s_mean_3_8=mean_s, tokens_per_s=tokens / mean_s,
        mfu_trainable=flops["flops_trainable"] / mean_s / 989e12,
        mfu_active=flops["flops_active"] / mean_s / 989e12,
        peak_mem_bytes=peak, launches=launches,
        launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
        lion=lion_counts, clip_bit_identical=clip_same)
    check(len(logs) == TRAIN_STEPS, f"{len(logs)} logged steps")
    check(all(math.isfinite(x) for x in losses + norms),
          "finite losses and gradient norms")
    check(losses[-1] < losses[1], f"loss of step 8 {losses[-1]} below step 2 "
                                  f"{losses[1]}")
    check(clip_same, "the frozen CLIP tower is bit-identical after training")
    layers = cfg.decoder.layers
    check(launches["flash_bwd_prep"] == launches["flash_bwd_dkv"]
          == launches["flash_bwd_dq"] == layers * TRAIN_STEPS,
          f"backward kernel launches {launches}: one pre-pass, dK/dV and dQ "
          f"per layer and step")
    check(launches["flash_fwd"] > 0
          and launches["flash_fwd_prep"] == launches["flash_fwd"],
          f"flash forward launches {launches}: one rotation per forward")
    check(lion_counts == {"launches": 3 * TRAIN_STEPS, "leaves": TRAIN_STEPS
                          * len(trainer.optimizer.params)},
          f"Lion launches {lion_counts}: three a step over every leaf")
    return launches, dict(step_s_mean_3_8=mean_s,
                          tokens_per_s=tokens / mean_s, peak_mem_bytes=peak)


FLASH_KERNELS = ("flash_fwd", "flash_fwd_prep", "flash_bwd_prep",
                 "flash_bwd_dkv", "flash_bwd_dq")


def flash_counters(fa) -> dict:
    return {"flash_fwd": fa.flash_attention, "flash_fwd_prep": fa.flash_fwd_prep,
            "flash_bwd_prep": fa.flash_bwd_prep,
            "flash_bwd_dkv": fa.flash_bwd_dkv, "flash_bwd_dq": fa.flash_bwd_dq}


def phase_dropout_remat(dev, kx, fa) -> None:
    """Phase 8b: phase 8's depth-cut fp32 Kosmos (2 decoder and 2 ViT
    layers) under dropout 0.1 on a CUDA generator: with attention dropout
    (plain attention, no flash launch), remat "dots" and remat off give the
    same gradients; with attention dropout 0 (flash on), "nothing", "dots"
    and "dots_no_batch" do, each within 1e-5 of each gradient's largest
    value."""
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.train.trainer import kosmos_loss_fn, value_and_grad

    c = kx.core.config
    base = c.KosmosConfig(
        decoder=c.MagnetoConfig(layers=2, dropout=0.1, attention_dropout=0.1),
        vision=c.VisionConfig(layers=2))
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    model = Kosmos(base, generator=g, device=dev)
    tokens = torch.randint(4, base.decoder.vocab_size, (2, 448), generator=g,
                           device=dev)
    tokens[:, 0] = 0
    tokens[1, 400:] = base.decoder.padding_idx
    batch = {"text_tokens": tokens,
             "images": pixels(2, g, dev, base.vision.image_size)}
    counters = flash_counters(fa)

    def grads(**dec):
        cfg = dataclasses.replace(base, decoder=dataclasses.replace(
            base.decoder, **dec))
        model.config = cfg
        before = counters["flash_fwd"].launches
        (loss, _), gr = value_and_grad(
            kosmos_loss_fn(cfg), model, batch,
            torch.Generator(device=dev).manual_seed(SEED + 12),
            freeze=("clip",))
        return loss.item(), gr, counters["flash_fwd"].launches - before

    def worst(ref, other):
        out = 0.0
        for n, r in ref.items():
            if r is None:
                check(other[n] is None, f"{n}: a gradient in one run only")
                continue
            out = max(out, rel_err(other[n], r))
        return out

    results = {}
    loss0, ref, flash0 = grads()
    loss1, dots, flash1 = grads(remat=True, remat_policy="dots")
    results["attention_dropout"] = dict(
        loss=loss0, loss_remat_dots=loss1, flash_launches=[flash0, flash1],
        max_rel_grad_err=worst(ref, dots))
    del ref, dots
    runs = {p: grads(attention_dropout=0.0, remat=p is not None,
                     remat_policy=p or "nothing")
            for p in (None, "nothing", "dots", "dots_no_batch")}
    ref = runs[None][1]
    results["flash"] = dict(
        losses={str(p): r[0] for p, r in runs.items()},
        flash_launches={str(p): r[2] for p, r in runs.items()},
        max_rel_grad_err={p: worst(ref, runs[p][1])
                          for p in ("nothing", "dots", "dots_no_batch")})
    log("dropout_remat", layers=2, dtype="float32", positions=512,
        dropout=0.1, bar=1e-5, **results)
    a = results["attention_dropout"]
    check(a["max_rel_grad_err"] <= 1e-5,
          f"dropout gradients, remat dots against none: {a}")
    check(a["flash_launches"] == [0, 0],
          f"attention dropout launched flash: {a['flash_launches']}")
    f = results["flash"]
    check(all(e <= 1e-5 for e in f["max_rel_grad_err"].values()),
          f"dropout gradients with flash under the remat policies: {f}")
    check(all(n > 0 for n in f["flash_launches"].values()),
          f"flash not launched with attention dropout 0: {f}")


# phase 9b: words of the captions (8 images, long captions) and of the
# phase 9d text file
CAPTION_WORDS = ("a photo of the small red cat sitting on a wooden table "
                 "next to blue cup and green plant in bright room").split()


def seeded_text(rng, words: int) -> str:
    return " ".join(rng.choice(CAPTION_WORDS, words))


def write_caption_dir(root: Path, n: int = 8, size: int = 224) -> None:
    """``n`` uint8 (size, size, 3) ``.npy`` images and a ``captions.jsonl``
    of captions of about 2,000 characters (tokens, to the byte tokenizer),
    made from the seed."""
    import numpy as np

    rng = np.random.RandomState(SEED + 13)
    lines = []
    for i in range(n):
        np.save(root / f"{i}.npy",
                rng.randint(0, 256, (size, size, 3)).astype(np.uint8))
        lines.append(json.dumps({"image": f"{i}.npy",
                                 "text": seeded_text(rng, 420)}))
    (root / "captions.jsonl").write_text("\n".join(lines) + "\n")


TRAIN_REAL_STEPS = 8


def step_reading(fn) -> dict:
    """One call of ``fn`` (an optimizer step) under ``torch.profiler``: its
    kernels and copies on the card (``launches``), their device time, and
    the call's host time to return."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    launches = device_ms = 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            launches += evt.count
            us = getattr(evt, "self_device_time_total", None)
            device_ms += (evt.self_cuda_time_total if us is None else us) / 1e3
    return {"launches": launches, "device_ms": device_ms, "host_ms": host_ms}


def optimizer_step_reading(opt, grads) -> dict:
    """One optimizer step's wall time (synchronised) and its kernel
    launches and device time (``step_reading``)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.step(grads)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    r = step_reading(lambda: opt.step(grads))
    return {"wall_ms": wall_ms, "device_ms": r["device_ms"],
            "launches": r["launches"]}


def phase_train_real(dev, kx, fa) -> dict:
    """Phase 9b: phase 9's flagship recipe on real-format data through the
    kernels: AdamW8bit, ``grad_accum=2``, remat "dots_no_batch", dropout
    0.1 (attention dropout 0: flash stays on), batches from
    ``image_caption_batches`` over 8 ``.npy`` images and long captions
    written from the seed, 2 x 1984 text positions, 8 micro-steps (4
    updates)."""
    import tempfile

    from kosmosx_torch.data.tokenizer import KosmosTokenizer
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.train.data import image_caption_batches
    from kosmosx_torch.train.trainer import TrainConfig, Trainer, kosmos_loss_fn

    base = train_config(kx)
    cfg = dataclasses.replace(base, decoder=dataclasses.replace(
        base.decoder, dropout=0.1, attention_dropout=0.0,
        remat_policy="dots_no_batch"))
    tcfg = TrainConfig(batch_size=2, seq_len=TRAIN_TEXT, learning_rate=1e-4,
                       optimizer="adamw8bit", schedule="constant",
                       warmup_steps=1, total_steps=TRAIN_REAL_STEPS,
                       grad_accum=2, checkpoint_every=0, log_every=1,
                       freeze=("clip",), seed=SEED + 14)
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    write_caption_dir(root)
    tok = KosmosTokenizer(image_size=cfg.vision.image_size,
                          image_embed_len=cfg.image_embed_len)
    batches = image_caption_batches(str(root), tok, batch_size=2,
                                    text_len=TRAIN_TEXT, epochs=None)
    trainer = Trainer(lambda g: Kosmos(cfg, generator=g, device=dev),
                      kosmos_loss_fn(cfg), tcfg, device=dev)
    state = trainer.init_state()
    model = state["params"]
    named = dict(model.named_parameters())
    clip0 = {n: p.detach().clone() for n, p in named.items()
             if n.startswith("clip")}
    sampled = ("decoder.layers.0.attn.q.A.w",
               f"decoder.layers.{cfg.decoder.layers - 1}.ffn.A.fc2.w",
               "image_proj.w", "resampler.latents")
    last = {n: named[n].detach().clone() for n in sampled}
    logs, stamps, changed = [], [], []

    def log_fn(step, m):
        stamps.append(time.perf_counter())
        logs.append(m)
        now = {n: named[n].detach().clone() for n in sampled}
        changed.append(sorted(n for n in sampled
                              if not torch.equal(now[n], last[n])))
        last.update(now)

    counters = flash_counters(fa)
    for fn in counters.values():
        fn.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.run(batches, steps=TRAIN_REAL_STEPS, log_fn=log_fn)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    tmp.cleanup()
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    mean_s = sum(step_s[2:]) / len(step_s[2:])
    tokens = 2 * (TRAIN_TEXT + cfg.image_embed_len)
    opt = trainer.optimizer
    trainable = sum(p.numel() for p in opt.params.values())
    moment_bytes = opt.moment_bytes()
    formula = trainable * 2 * (1 + 4 / 256)
    acc_bytes = sum(t.numel() * t.element_size() for t in opt.acc.values())
    losses = [m["loss"] for m in logs]
    norms = [m["grad_norm"] for m in logs]
    clip_same = all(torch.equal(named[n], p) for n, p in clip0.items())
    opt_step = optimizer_step_reading(opt.inner, opt.acc)
    log("train_real", micro_steps=TRAIN_REAL_STEPS, grad_accum=2,
        optimizer="adamw8bit", remat_policy="dots_no_batch", dropout=0.1,
        batch=[2, TRAIN_TEXT + cfg.image_embed_len], trainable=trainable,
        losses=losses, grad_norms=norms, lrs=[m["lr"] for m in logs],
        changed_per_step=changed, step_s=step_s, step_s_mean_3_8=mean_s,
        tokens_per_s=tokens / mean_s, peak_mem_bytes=peak,
        moment_bytes=moment_bytes, moment_bytes_formula=formula,
        accumulator_bytes=acc_bytes, launches=launches,
        optimizer_step=opt_step, clip_bit_identical=clip_same)
    check(len(logs) == TRAIN_REAL_STEPS, f"{len(logs)} logged micro-steps")
    check(all(math.isfinite(x) for x in losses + norms),
          "finite losses and gradient norms")
    check(all(bool(c) == (i % 2 == 1) and (not c or len(c) == len(sampled))
              for i, c in enumerate(changed)),
          f"parameters changed at micro-steps {changed}: want all sampled "
          f"tensors at 2, 4, 6, 8 and none between")
    check(sum(losses[6:]) < sum(losses[:2]),
          f"mean loss of micro-steps 7-8 {losses[6:]} not below 1-2 "
          f"{losses[:2]}")
    check(clip_same, "the frozen CLIP tower is bit-identical after training")
    layers = cfg.decoder.layers
    check(launches["flash_bwd_prep"] == launches["flash_bwd_dkv"]
          == launches["flash_bwd_dq"] == layers * TRAIN_REAL_STEPS,
          f"backward kernel launches {launches}: 24 per micro-step")
    check(abs(moment_bytes - formula) <= 0.01 * formula,
          f"moment bytes {moment_bytes} against {formula}")
    del trainer, state, model, named
    return launches


def phase_train_1chip(dev, kx, fa) -> dict:
    """Phase 9c: examples/train_flagship_1chip.py's recipe: the text
    decoder with bf16 parameters, Lion8bit, remat "dots", flash, dropout
    off, 6 steps at 2 x 2048 on one batch of synthetic text, repeated (as
    phase 9 repeats its batch) so that the loss must fall: fresh batches
    of this stream are each as hard as the last to a model six steps from
    its init. The loss on a fresh batch the run does not train on, before
    and after the 6 steps, is reported beside it, not checked."""
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.train.data import synthetic_text_batches
    from kosmosx_torch.train.trainer import TrainConfig, Trainer, lm_loss_fn

    c = kx.core.config
    cfg = c.MagnetoConfig(compute_dtype="bfloat16", scan_layers=True,
                          remat=True, remat_policy="dots", dropout=0.0,
                          attention_dropout=0.0, use_flash_attention=True,
                          max_positions=8194)
    steps, seq = 6, 2048
    tcfg = TrainConfig(batch_size=2, seq_len=seq, learning_rate=1e-4,
                       optimizer="lion8bit", schedule="constant",
                       total_steps=steps, warmup_steps=1, checkpoint_every=0,
                       log_every=1, seed=SEED + 15)
    trainer = Trainer(
        lambda g: KosmosLanguage(cfg, generator=g, device=dev).to(
            torch.bfloat16), lm_loss_fn(cfg), tcfg, device=dev)
    state = trainer.init_state()
    logs, stamps = [], []

    def log_fn(step, m):
        stamps.append(time.perf_counter())
        logs.append(m)

    held_out = next(synthetic_text_batches(
        batch_size=2, seq_len=seq, vocab_size=cfg.vocab_size, seed=SEED + 1))
    held_before = trainer.evaluate([held_out])["eval_loss"]
    counters = flash_counters(fa)
    before = {n: fn.launches for n, fn in counters.items()}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batch = next(synthetic_text_batches(batch_size=2, seq_len=seq,
                                        vocab_size=cfg.vocab_size, seed=SEED))
    trainer.run(itertools.repeat(batch, steps), log_fn=log_fn)
    peak = torch.cuda.max_memory_allocated()
    launches = {n: fn.launches - before[n] for n, fn in counters.items()}
    held_after = trainer.evaluate([held_out])["eval_loss"]
    params = sum(p.numel() for p in state["params"].parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in state["params"].parameters())
    moment_bytes = trainer.optimizer.moment_bytes()
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    mean_s = sum(step_s[2:]) / len(step_s[2:])
    losses = [m["loss"] for m in logs]
    log("train_1chip", steps=steps, batch=[2, seq], optimizer="lion8bit",
        param_dtype="bfloat16", params=params, param_bytes=param_bytes,
        moment_bytes=moment_bytes, moment_bytes_formula=params * (1 + 4 / 256),
        losses=losses, grad_norms=[m["grad_norm"] for m in logs],
        held_out_loss_before=held_before, held_out_loss_after=held_after,
        step_s=step_s, step_s_mean_3_6=mean_s, tokens_per_s=2 * seq / mean_s,
        peak_mem_bytes=peak, launches=launches)
    check(len(logs) == steps and all(math.isfinite(x) for x in losses),
          f"finite losses {losses}")
    check(losses[-1] < losses[0], f"loss of step 6 {losses[-1]} not below "
                                  f"step 1 {losses[0]}")
    return launches


def run_child(args, timeout: int = 900) -> dict:
    """Run a command in a child process; rc, seconds and its output's
    tails."""
    t0 = time.perf_counter()
    proc = subprocess.run(args, capture_output=True, text=True,
                          timeout=timeout, cwd=Path(__file__).resolve().parent)
    return {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
            "stdout": proc.stdout, "stderr": proc.stderr}


def child_reports(out: str) -> list:
    """The JSON lines a ``--cli`` child prints, one a CLI run."""
    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith('{"cli"')]


def jsonl_records(path: Path) -> list:
    if not path.exists():
        return []
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln]


# the CLIs at full width: 2048 positions need a learned table of 2050 rows
# (positions start after the padding index), more than the CLIs' default
# of 2048
CLI_SEQ = ["--seq-len", "2048", "--max-positions", "2050"]
CLI_TRAIN = ["--model", "language", "--batch-size", "2", "--remat",
             "--optimizer", "lion8bit", "--grad-accum", "2", "--log-every",
             "1", "--device", "cuda"] + CLI_SEQ
CLI_LAYERS = 4   # 9d's train and eval CLIs: full width, depth cut


def phase_cli_train_eval(dev) -> dict:
    """Phase 9d: the training and eval CLIs at full width and CLI_LAYERS
    layers: train 4 micro-steps (dropout at its defaults), then evaluate
    the checkpoint; at a 2-layer cut, 4 steps against 2, ``--lora-rank``
    writing an adapter the serving CLI serves, and ``--dpo`` with LoRA on a
    preference file: all in one child process on the card (``--cli``, one
    CLI ``main`` after another), then ``--resume`` for 2 more steps in a
    fresh one (``python -m``)."""
    import tempfile

    import numpy as np

    gc.collect()
    torch.cuda.empty_cache()
    py = sys.executable
    me = str(Path(__file__).resolve())
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rng = np.random.RandomState(SEED + 16)
        text = tmp / "corpus.txt"
        text.write_text("\n".join(seeded_text(rng, int(rng.randint(40, 400)))
                                  for _ in range(300)) + "\n")
        run = tmp / "run"

        def resume_argv(name, steps, *extra):
            return [*CLI_TRAIN, "--layers", "2", "--text-files", str(text),
                    "--schedule", "constant", "--warmup-steps", "1",
                    "--steps", str(steps), "--checkpoint-every", "2",
                    "--no-final-save", "--output-dir", str(tmp / name),
                    "--metrics-jsonl", str(tmp / f"{name}.jsonl"), *extra]

        # LoRA and DPO through the CLIs at full width, depth cut to 2
        # layers: the adapter the training CLI writes, served by the
        # serving CLI; DPO with LoRA on a preference file
        cut = ["--layers", "2", "--device", "cuda"]
        adapter = tmp / "lora" / "adapter"
        prefs = tmp / "prefs.jsonl"
        write_prefs(prefs, rng, DPO_ROWS)
        runs = [
            ("train", [*CLI_TRAIN, "--layers", str(CLI_LAYERS),
                       "--text-files", str(text), "--steps", "4",
                       "--checkpoint-every", "4", "--no-final-save",
                       "--output-dir", str(run), "--metrics-jsonl",
                       str(tmp / "train.jsonl")]),
            ("eval", ["--checkpoint", str(run), "--data", str(text),
                      "--max-batches", "2", "--layers", str(CLI_LAYERS),
                      "--device", "cuda", *CLI_SEQ]),
            ("train", resume_argv("whole", 4)),
            ("train", resume_argv("split", 2)),
            ("train", [*cut, "--synthetic", "--seq-len", "512",
                       "--batch-size", "2", "--lora-rank", "4", "--steps",
                       "4", "--checkpoint-every", "0", "--output-dir",
                       str(tmp / "lora")]),
            ("serve", [*cut, "--adapter", f"a={adapter}", "--use-adapter",
                       "a", "--prompt", "a photo of", "--max-new-tokens",
                       "8"]),
            ("train", [*cut, "--model", "language", "--dpo", str(prefs),
                       "--lora-rank", "4", "--seq-len", str(DPO_LENGTH),
                       "--batch-size", str(DPO_BATCH), "--steps", "2",
                       "--checkpoint-every", "0", "--no-final-save",
                       "--output-dir", str(tmp / "dpo")])]
        argv = [py, me, "--cli"]
        for i, (name, args) in enumerate(runs):
            argv += (["--then"] if i else []) + [name, *args]
        child = run_child(argv)
        reports = child_reports(child["stdout"])
        reports += [{}] * (len(runs) - len(reports))
        resumed = run_child([py, "-m", "kosmosx_torch.scripts.train",
                             *resume_argv("split", 2, "--resume")])
        tail = child["stderr"][-1500:]
        records = jsonl_records(tmp / "train.jsonl")
        train, evaluated, whole, split, lora, served, dpo = reports
        out["child"] = dict(rc=child["rc"], seconds=child["seconds"],
                            stderr=tail if child["rc"] else "")
        out["train"] = dict(rc=train.get("rc"), seconds=train.get("seconds"),
                            records=len(records),
                            losses=[r["loss"] for r in records],
                            report=train)
        out["eval"] = dict(rc=evaluated.get("rc"),
                           seconds=evaluated.get("seconds"),
                           result=evaluated.get("result", {}),
                           report=evaluated)
        whole_l = {r["step"]: r["loss"]
                   for r in jsonl_records(tmp / "whole.jsonl")}
        split_l = {r["step"]: r["loss"]
                   for r in jsonl_records(tmp / "split.jsonl")}
        rel = max((abs(split_l[s] - whole_l[s]) / abs(whole_l[s])
                   for s in (3, 4) if s in split_l and s in whole_l),
                  default=float("inf"))
        out["resume"] = dict(rcs=[whole.get("rc"), split.get("rc"),
                                  resumed["rc"]],
                             seconds=[whole.get("seconds"),
                                      split.get("seconds"),
                                      resumed["seconds"]],
                             whole=whole_l, split=split_l,
                             max_rel_loss_diff=rel,
                             stderr=resumed["stderr"][-800:]
                             if resumed["rc"] else "")
        out["lora"] = dict(rc=lora.get("rc"), seconds=lora.get("seconds"),
                           adapter=(adapter / "params.pt").is_file())
        out["serve_adapter"] = dict(rc=served.get("rc"),
                                    seconds=served.get("seconds"))
        out["dpo"] = dict(rc=dpo.get("rc"), seconds=dpo.get("seconds"))
    log("cli_train_eval", **out)
    t, e, r, lo = out["train"], out["eval"], out["resume"], out["lora"]
    check(child["rc"] == 0, f"the CLI child: rc {child['rc']}: {tail}")
    check(t["rc"] == 0 and t["records"] == 4,
          f"train CLI: rc {t['rc']}, {t['records']} records")
    check(t["report"].get("native_packing") is True,
          f"train CLI packed without the native library: {t['report']}")
    check(e["rc"] == 0 and math.isfinite(e["result"].get("perplexity",
                                                         float("nan"))),
          f"eval CLI: {e}")
    check(e["report"].get("launches", {}).get("flash_fwd")
          == CLI_LAYERS * e["result"].get("batches", -1),
          f"eval CLI flash launches {e['report']}: {CLI_LAYERS} per batch")
    check(r["rcs"] == [0, 0, 0] and sorted(r["split"]) == [1, 2, 3, 4]
          and r["max_rel_loss_diff"] <= 1e-3,
          f"resume: {r}")
    check(lo["rc"] == 0 and lo["adapter"], f"--lora-rank: {lo}")
    check(out["serve_adapter"]["rc"] == 0,
          f"serving CLI --adapter: {out['serve_adapter']}")
    check(out["dpo"]["rc"] == 0, f"--dpo --lora-rank: {out['dpo']}")
    return {name: {"9d_train_cli": t["report"]["launches"][name],
                   "9d_eval_cli": e["report"]["launches"][name]}
            for name in FLASH_KERNELS}


def cli_child(runs: list) -> int:
    """``chip_smoke.py --cli NAME ARGV [--then NAME ARGV ...]``: each CLI's
    ``main(ARGV)`` in this process in turn (NAME a module of
    ``kosmosx_torch.scripts``), each followed by one JSON line with its
    return code, seconds, the flash wrappers' launches during it, whether
    the native packing library is loaded, and the eval CLI's result line;
    the first CLI that fails ends the run."""
    import contextlib
    import importlib
    import io

    from kosmosx_torch.data import native
    from kosmosx_torch.ops import flash_attention as fa

    counters = flash_counters(fa)
    for name, argv in runs:
        cli = importlib.import_module(f"kosmosx_torch.scripts.{name}")
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(argv)
        result = next((json.loads(ln) for ln in printed.getvalue()
                       .splitlines() if ln.startswith('{"perplexity"')), None)
        print(printed.getvalue(), end="", flush=True)
        print(json.dumps({
            "cli": name, "rc": rc, "seconds": time.perf_counter() - t0,
            "launches": {n: fn.launches for n, fn in counters.items()},
            "native_packing": native._lib is not None,
            **({"result": result} if result is not None else {})}),
            flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        if rc:
            return rc
    return 0


def generation_requests(dev, cfg):
    """Phase 6's requests: 4 of one 224x224 image and 192/256/320/448 text
    tokens, right-padded, from a seed: (tokens, lengths, images)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    lengths = torch.tensor([192, 256, 320, 448], device=dev)
    tokens = torch.randint(4, cfg.decoder.vocab_size, (4, 448), generator=g,
                           device=dev)
    tokens[torch.arange(448, device=dev)[None] >= lengths[:, None]] = \
        cfg.decoder.padding_idx
    return tokens, lengths, pixels(4, g, dev)


def drive_generation(dev, model, cfg, kernels: dict, requests=None,
                     **decoder_kw) -> dict:
    """Greedy ``generate_multimodal`` with ``decode_attn_kernel=True`` (and
    ``decoder_kw`` on the decoder config) for ``requests`` (tokens, text
    lengths, images; phase 6's by default), 32 new tokens each: a first
    run with every counter of ``kernels`` (name -> wrapper) set to 0 just
    before and read just after, a second run for time and peak memory, and
    a prefill-only run."""
    from kosmosx_torch.generate.sampler import SamplingConfig, generate_multimodal

    gcfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, decode_attn_kernel=True, **decoder_kw))
    tokens, lengths, images = requests or generation_requests(dev, cfg)
    new = 32

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate_multimodal(model, gcfg, tokens, images,
                                  SamplingConfig(max_new_tokens=n, greedy=True),
                                  prompt_lengths=lengths)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for fn in kernels.values():
        fn.launches = 0
        if hasattr(fn, "hopper_launches"):
            fn.hopper_launches = 0
    first, _ = run(new)
    launches = {name: fn.launches for name, fn in kernels.items()}
    launches.update({f"{name}.hopper": fn.hopper_launches
                     for name, fn in kernels.items()
                     if hasattr(fn, "hopper_launches")})
    torch.cuda.reset_peak_memory_stats()
    second, total_s = run(new)
    peak = torch.cuda.max_memory_allocated()
    _, prefill_s = run(1)
    check(tuple(first.shape) == (4, new), f"token shape {tuple(first.shape)}")
    check(bool(((first >= 0) & (first < cfg.decoder.vocab_size)).all()),
          "ids in the vocabulary")
    check(torch.equal(first, second), "two runs give identical tokens")
    return dict(requests=4, text_lengths=lengths.tolist(), new_tokens=new,
                shape=list(first.shape), launches=launches, total_s=total_s,
                prefill_s=prefill_s,
                decode_step_ms=(total_s - prefill_s) / (new - 1) * 1e3,
                tok_per_s=4 * new / total_s, peak_mem_bytes=peak,
                tokens=first)


def phase_generate(dev, kx, fa, da, model, cfg):
    result = drive_generation(dev, model, cfg, {
        "flash": fa.flash_attention, "decode": da.decode_attention})
    first = result.pop("tokens")
    launches = result["launches"]
    log("generate", **result, tokens_row0=first[0, :8].tolist())
    check(launches["flash"] > 0 and launches["decode"] > 0,
          f"both kernels launched in generation: {launches}")
    return launches, dict(result, tokens=first)


# phase 6e: raw images of non-square sizes (H, W), and the spliced lengths
# of its 4 texts (phase 6's)
RAW_IMAGE_SIZES = ((480, 640), (300, 400), (224, 299), (640, 480))
RAW_TEXT_LENGTHS = (192, 256, 320, 448)
RAW_TEXT = ("A picture of a street at night, with wet cobbles, a tram and "
            "three people under one umbrella. ")


def rel_frobenius(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.float(), ref.float()
    return ((a - ref).norm() / ref.norm()).item()


def cache_copy(caches) -> list:
    return [{n: t.clone() for n, t in c.items()} for c in caches]


def cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for c in caches for t in c.values())


def step_logits(params, dcfg, caches, tok, index, *, kernel: bool,
                double_scale: bool = False, center=None) -> torch.Tensor:
    """One decode step's fp32 logits (B, V) on a copy of ``caches``, through
    the decode kernel or plain attention."""
    from kosmosx_torch.generate.sampler import _decode_logits

    cfg = dataclasses.replace(dcfg, decode_attn_kernel=kernel)
    with torch.inference_mode():
        return _decode_logits(params, cfg, tok[:, None], cache_copy(caches),
                              index, double_scale=double_scale,
                              xpos_center=center)[:, 0].float()


def raw_requests(dev, cfg):
    """Phase 6e's requests from raw inputs: 4 uint8 images of
    ``RAW_IMAGE_SIZES`` through ``KosmosTokenizer.tokenize_images`` on the
    card, each held against the same call on the CPU, and 4 texts through
    ``tokenize_texts``, whose spliced lengths are ``RAW_TEXT_LENGTHS``.
    Returns (tokens, lengths, images) on the card and the image errors."""
    from kosmosx_torch.data.tokenizer import KosmosTokenizer

    tok = KosmosTokenizer(use_hf=False)
    g = torch.Generator().manual_seed(SEED + 16)
    images, errs = [], []
    for h, w in RAW_IMAGE_SIZES:
        img = torch.randint(0, 256, (1, 3, h, w), generator=g,
                            dtype=torch.uint8)
        on_card = tok.tokenize_images(img.to(dev))
        errs.append(max_err(on_card.cpu(), tok.tokenize_images(img)))
        images.append(on_card)
    # BOS and the two image tags come before each text's bytes
    texts = [(RAW_TEXT * 8)[:n - 3] for n in RAW_TEXT_LENGTHS]
    ids, _ = tok.tokenize_texts(texts)
    tokens = torch.as_tensor(ids, device=dev).long()
    lengths = (tokens != tok.pad_token_id).sum(dim=1)
    check(tokens.shape[1] == max(RAW_TEXT_LENGTHS)
          and lengths.tolist() == list(RAW_TEXT_LENGTHS),
          f"raw text lengths {lengths.tolist()}")
    check(tok.pad_token_id == cfg.decoder.padding_idx
          and tok.vocab_size <= cfg.decoder.vocab_size,
          "the byte tokenizer's ids fit the decoder")
    return (tokens, lengths, torch.cat(images)), errs


def phase_int8_kv(dev, fa, da, model, cfg, bf16):
    """Phase 6e: raw images and texts, then phase 6's request shape with an
    int8 KV cache: ids in the vocabulary, two runs identical, the decode
    kernel on the int8 cache at every step of every layer; one decode
    step's logits through the kernel against plain attention on copies of
    the same caches; the int8 cache's bytes against a bf16 cache's."""
    from kosmosx_torch.generate import sampler
    from kosmosx_torch.nn import decoder as dec

    requests, image_errs = raw_requests(dev, cfg)
    log("raw_inputs", image_sizes=[list(s) for s in RAW_IMAGE_SIZES],
        card_vs_cpu_max_abs_err=image_errs, bar=1e-4,
        text_lengths=list(RAW_TEXT_LENGTHS))
    check(max(image_errs) < 1e-4, f"tokenize_images card vs CPU {image_errs}")
    result = drive_generation(dev, model, cfg, {
        "flash": fa.flash_attention, "decode": da.decode_attention},
        requests=requests, kv_cache_dtype="int8")
    first = result.pop("tokens")
    launches = result["launches"]
    tokens, lengths, images = requests
    # the same requests on a bf16 cache, for the token agreement
    gcfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, decode_attn_kernel=True))
    same_bf16 = sampler.generate_multimodal(
        model, gcfg, tokens, images,
        sampler.SamplingConfig(max_new_tokens=32, greedy=True),
        prompt_lengths=lengths)
    # one decode step after the prefill, kernel against plain attention
    dcfg = dataclasses.replace(cfg.decoder, kv_cache_dtype="int8")
    max_len = sampler._mm_max_len(cfg, tokens, images, 32)
    with torch.inference_mode():
        x, full = sampler._mm_prompt(model, cfg, tokens, images, lengths)
        caches = dec.init_cache(dcfg, 4, max_len, device=dev)
        tok = sampler._prefill(model["decoder"], dcfg, x, caches, full).argmax(-1)
    kw = dict(double_scale=cfg.parity_double_scale)
    kernel = step_logits(model["decoder"], dcfg, caches, tok, full,
                         kernel=True, **kw)
    plain = step_logits(model["decoder"], dcfg, caches, tok, full,
                        kernel=False, **kw)
    step_err = rel_frobenius(kernel, plain)
    ratio = cache_bytes(caches) / cache_bytes(dec.init_cache(
        cfg.decoder, 4, max_len, device=dev))
    keys = ("prefill_s", "decode_step_ms", "tok_per_s", "peak_mem_bytes")
    log("int8_kv_generate", **result, tokens_row0=first[0, :8].tolist(),
        step_rel_frobenius_kernel_vs_plain=step_err, step_bar=2e-2,
        cache_bytes_ratio_vs_bf16=ratio, cache_bytes_bar=0.55,
        token_agreement_vs_bf16_cache=(first == same_bf16).float().mean().item(),
        bf16=({k: bf16[k] for k in keys}))
    layers = cfg.decoder.layers
    check(launches["decode"] == layers * 31,
          f"decode kernel launches on the int8 cache {launches['decode']}, "
          f"want {layers} x 31")
    check(step_err <= 2e-2, f"int8 decode step kernel vs plain {step_err}")
    check(ratio <= 0.55, f"int8 cache bytes ratio {ratio}")
    del caches
    return launches["decode"]


WINDOW, WINDOW_SINK, WINDOW_NEW = 512, 4, 352
WINDOW_LENGTHS = (224, 232, 248, 256)


def window_requests(dev, cfg):
    """Phase 6f's text prompts: 4 of ``WINDOW_LENGTHS`` tokens, right-padded,
    from a seed: (tokens, lengths)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    lengths = torch.tensor(WINDOW_LENGTHS, device=dev)
    width = max(WINDOW_LENGTHS)
    tokens = torch.randint(4, cfg.decoder.vocab_size, (4, width), generator=g,
                           device=dev)
    tokens[torch.arange(width, device=dev)[None] >= lengths[:, None]] = \
        cfg.decoder.padding_idx
    return tokens, lengths


def window_config(cfg):
    return dataclasses.replace(cfg.decoder, kv_window=WINDOW,
                               kv_sink=WINDOW_SINK, decode_attn_kernel=True)


def phase_window(dev, da, model, cfg):
    """Phase 6f: ``generate_text`` on the flagship decoder with a rolling
    window of 512 slots (4 sinks) for 352 new tokens, so that every row's
    writes wrap by 63 slots or more: ids in the vocabulary, two runs
    identical (the second through the loop's internals, which keep the
    final caches), the decode kernel at every step; then at the step after
    the last, the kernel against plain attention and the caches re-centered
    by 4096 positions against the same step without re-centering."""
    from kosmosx_torch.generate import sampler
    from kosmosx_torch.nn import decoder as dec

    dcfg = window_config(cfg)
    params = model["decoder"]
    tokens, lengths = window_requests(dev, cfg)
    scfg = sampler.SamplingConfig(max_new_tokens=WINDOW_NEW, greedy=True)

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler.generate_text(
            params, dcfg, tokens,
            sampler.SamplingConfig(max_new_tokens=n, greedy=True),
            prompt_lengths=lengths)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    da.decode_attention.launches = 0
    first, total_s = run(WINDOW_NEW)
    launches = da.decode_attention.launches
    _, prefill_s = run(1)
    with torch.inference_mode():
        x, _ = dec.forward_embedding(params, dcfg, tokens)
        second, state = sampler._generate(params, dcfg, x, lengths, scfg,
                                          tokens.shape[1] + WINDOW_NEW, None,
                                          False)
    # positions past the window, each written into a reused ring slot
    wrapped = (state.index - WINDOW).tolist()
    kernel = step_logits(params, dcfg, state.caches, state.tok, state.index,
                         kernel=True, center=state.center)
    plain = step_logits(params, dcfg, state.caches, state.tok, state.index,
                        kernel=False, center=state.center)
    moved = dec.recenter_caches(state.caches, 4096, dcfg)
    recentered = step_logits(params, dcfg, moved, state.tok, state.index,
                             kernel=True, center=state.center + 4096)
    del moved
    kernel_err = rel_frobenius(kernel, plain)
    recenter_err = rel_frobenius(recentered, kernel)
    steps = WINDOW_NEW - 1
    result = dict(requests=4, text_lengths=list(WINDOW_LENGTHS),
                  new_tokens=WINDOW_NEW, kv_window=WINDOW, kv_sink=WINDOW_SINK,
                  cache_positions=state.caches[0]["k"].shape[2],
                  wrapped_slots=wrapped, decode_launches=launches,
                  total_s=total_s, prefill_s=prefill_s,
                  decode_step_ms=(total_s - prefill_s) / steps * 1e3,
                  tok_per_s=4 * WINDOW_NEW / total_s,
                  step_rel_frobenius_kernel_vs_plain=kernel_err,
                  recentered_rel_frobenius=recenter_err, bar=2e-2,
                  recentered_finite=bool(torch.isfinite(recentered).all()))
    log("window_generate", **result, tokens_row0=first[0, -8:].tolist())
    check(result["cache_positions"] == WINDOW, f"window cache {result}")
    check(tuple(first.shape) == (4, WINDOW_NEW)
          and bool(((first >= 0) & (first < cfg.decoder.vocab_size)).all()),
          "window ids in the vocabulary")
    check(torch.equal(first, second), "two window runs give identical tokens")
    check(min(wrapped) >= 62, f"every row wraps by 62 slots or more: {wrapped}")
    check(launches == dcfg.layers * steps,
          f"decode kernel launches in the window run {launches}, want "
          f"{dcfg.layers} x {steps}")
    check(kernel_err <= 2e-2, f"window step kernel vs plain {kernel_err}")
    check(recenter_err <= 2e-2, f"re-centered step {recenter_err}")
    return launches


SPEC_LENGTHS = (100, 112, 120, 128)


def phase_beam_speculative(dev, da, model, cfg):
    """Phase 6g: ``beam_search_multimodal`` (beam 4) on 2 of phase 6's
    requests, 16 new tokens: ids in the vocabulary, normalised scores
    finite and sorted, two runs identical, the decode kernel launched. Then
    greedy ``speculative_generate`` (gamma 4) on 4 text prompts, 48 new
    tokens, with a 2-layer draft of the flagship width from a seed: ids in
    the vocabulary, two runs identical; the acceptance rate and the token
    agreement with ``generate_text`` are reported, not held (bf16
    near-ties differ between a chunked verify and one-token steps)."""
    from kosmosx_torch.generate import sampler
    from kosmosx_torch.generate.beam import beam_search_multimodal
    from kosmosx_torch.generate.speculative import speculative_generate

    gcfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, decode_attn_kernel=True))
    tokens, lengths, images = generation_requests(dev, cfg)
    tokens, lengths, images = tokens[:2, :256], lengths[:2], images[:2]
    vocab = cfg.decoder.vocab_size
    launches = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def beam():
        return beam_search_multimodal(model, gcfg, tokens, images, beam_size=4,
                                      max_new_tokens=16, prompt_lengths=lengths)

    da.decode_attention.launches = 0
    (toks, norm, raw), beam_s = timed(beam)
    launches["beam"] = da.decode_attention.launches
    again = beam()
    sorted_ok = bool((norm[:, :-1] >= norm[:, 1:]).all())
    log("beam_generate", requests=2, text_lengths=lengths.tolist(), beam=4,
        new_tokens=16, seconds=beam_s, decode_launches=launches["beam"],
        normalized_scores=norm.tolist(), best_row0=toks[0, 0, :8].tolist())
    check(tuple(toks.shape) == (2, 4, 16)
          and bool(((toks >= 0) & (toks < vocab)).all()),
          "beam ids in the vocabulary")
    check(bool(torch.isfinite(norm).all()) and sorted_ok,
          f"beam scores finite and sorted: {norm.tolist()}")
    check(torch.equal(toks, again[0]) and torch.equal(norm, again[1]),
          "two beam runs are identical")
    check(launches["beam"] == cfg.decoder.layers * 15,
          f"decode kernel launches in beam search {launches['beam']}")

    dcfg = gcfg.decoder
    draft, draft_cfg, prompt, lengths = spec_setup(dev, dcfg)
    scfg = sampler.SamplingConfig(max_new_tokens=48, greedy=True)

    def spec():
        return speculative_generate(model["decoder"], draft, dcfg, draft_cfg,
                                    prompt, scfg, gamma=4,
                                    prompt_lengths=lengths)

    da.decode_attention.launches = 0
    (out, stats), spec_s = timed(spec)
    launches["speculative"] = da.decode_attention.launches
    out2, stats2 = spec()
    plain, plain_s = timed(lambda: sampler.generate_text(
        model["decoder"], dcfg, prompt, scfg, prompt_lengths=lengths))
    reading = dict(stats=stats, acceptance_rate=stats["accepted"]
                   / max(stats["proposed"], 1),
                   token_agreement_vs_generate_text=(
                       out == plain).float().mean().item())
    log("speculative_generate", requests=4, text_lengths=list(SPEC_LENGTHS),
        new_tokens=48, gamma=4, draft_layers=2, **reading,
        seconds=spec_s, generate_text_seconds=plain_s,
        decode_launches=launches["speculative"])
    check(tuple(out.shape) == (4, 48)
          and bool(((out >= 0) & (out < vocab)).all()),
          "speculative ids in the vocabulary")
    check(torch.equal(out, out2) and stats == stats2,
          "two speculative runs are identical")
    check(launches["speculative"] > 0,
          "the draft's steps launch the decode kernel")
    return launches, reading


def phase_cli():
    """Phase 6h: the generation CLI in this process, at full width: ``--model
    kosmos --image <uint8 .npy> --greedy --max-new-tokens 8``, then the same
    with ``--beam-size 2``; both return 0 and print 8 ids in the
    vocabulary."""
    import io
    import tempfile

    import numpy as np

    from kosmosx_torch.scripts import generate as cli

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "image.npy"
        np.save(path, np.random.RandomState(SEED).randint(
            0, 256, (3, 300, 400)).astype(np.uint8))
        for name, extra in (("greedy", []), ("beam", ["--beam-size", "2"])):
            argv = ["--model", "kosmos", "--image", str(path), "--greedy",
                    "--max-new-tokens", "8", "--seed", str(SEED)] + extra
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
            seconds = time.perf_counter() - t0
            line = next((ln for ln in out.getvalue().splitlines()
                         if ln.startswith("generated ids:")), "")
            ids = json.loads(line.split(":", 1)[1]) if line else []
            results[name] = dict(argv=argv, rc=rc, seconds=seconds, ids=ids)
            gc.collect()
            torch.cuda.empty_cache()
    log("cli", **results)
    vocab = cli.build_parser().parse_args([]).vocab_size
    for name, r in results.items():
        check(r["rc"] == 0 and len(r["ids"]) == 8
              and all(0 <= i < vocab for i in r["ids"]), f"CLI {name}: {r}")


W8_DECODE_KN = ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 32002))
W8_VOCAB = (2048, 32002)  # the vocab head's (K, N)
W8_SHAPES = ([(m, k, n) for m in (4, 8) for k, n in W8_DECODE_KN]
             + [(3968, 2048, 8192), (3968, *W8_VOCAB), (5, 130, 70),
                (514, 588, 1024)])
W8_VIT_SHAPE = (514, 1024, 4096)  # the ViT's FFN on 2 images
W8_STACK = (24, 2048, 8192)
W8_BARS = ((torch.float32, 1e-5), (torch.bfloat16, 1e-2))


def _w8_case(name, wrapper, kernel, plain, bar, want_path, **shape) -> dict:
    """One W8 kernel case against its plain version: the kernel the call
    took (``wrapper.hopper_launches`` moved or not) against the shape rule's
    ``want_path``, error relative to the reference's largest value, two
    launches bit-identical, device times (graph) and back-to-back launch
    times (host-bound at decode shapes)."""
    before = wrapper.hopper_launches
    y = kernel()
    path = "hopper" if wrapper.hopper_launches > before else (
        "mma" if want_path != "f32" else "f32")
    again, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = rel_err(y, ref)
    same = torch.equal(y, again)
    result = dict(path=path, max_abs_err=max_err(y, ref), max_rel_err=err,
                  bit_identical=same, ms=graph_ms(kernel),
                  plain_ms=graph_ms(plain), launch_ms=cuda_ms(kernel),
                  plain_launch_ms=cuda_ms(plain))
    log("w8_kernels", kernel=name, **shape, rel_bar=bar, **result)
    check(path == want_path, f"{name} {shape} took {path}, the shape rule "
                             f"says {want_path}")
    check(err < bar, f"{name} {shape} relative error {err} >= {bar}")
    check(same, f"{name} {shape}: two launches differ")
    return result


def _w8_path(qm, x, q) -> str:
    """The kernel the shape rule (``quant_matmul._w8_plan``) names for x
    times codes q (the last two dims are (K, N), rows q.stride(-2) apart)."""
    if x.dtype != torch.bfloat16:
        return "f32"
    (m, k), n = x.shape, q.shape[-1]
    return qm._w8_plan(m, k, n, x.data_ptr() % 16 == 0,
                       q.data_ptr() % 16 == 0, qm._sm_count(0),
                       q.stride(-2))[0]


def phase_w8_kernels(dev, qm):
    """Both W8 kernels against ``w8_matmul_plain`` at the main path's shapes
    (decode M 4 and 8 over the decoder's and the vocab head's weights,
    prefill M 3968) and ragged ones, fp32 (TF32 off) and bf16; the vocab
    head at M 4 and 3968 on dense codes too (key "dense"), the mma.sync
    kernel, as the vocab head ran before its codes had a padded pitch."""
    from kosmosx_torch.utils.quantize import _quantize_w

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    g_vit = torch.Generator(device=dev).manual_seed(SEED + 15)
    results = {}
    for (m, k, n), gen in [(shape, g) for shape in W8_SHAPES] + [
            (W8_VIT_SHAPE, g_vit)]:
        w = _quantize_w(torch.randn(k, n, generator=gen, device=dev) * 0.02)
        x = torch.randn(m, k, generator=gen, device=dev)
        for dtype, bar in W8_BARS:
            xx = x.to(dtype)
            results[(m, k, n, dtype)] = _w8_case(
                "w8_matmul", qm.w8_matmul,
                lambda: qm.w8_matmul(xx, w["q"], w["scale"]),
                lambda: qm.w8_matmul_plain(xx, w["q"], w["scale"]), bar,
                _w8_path(qm, xx, w["q"]), m=m, k=k, n=n,
                dtype=str(dtype).split(".")[-1])
        if (k, n) == W8_VOCAB and m in (4, 3968):
            dense, xx = w["q"].contiguous(), x.bfloat16()
            results[("dense", m, k, n, torch.bfloat16)] = _w8_case(
                "w8_matmul", qm.w8_matmul,
                lambda: qm.w8_matmul(xx, dense, w["scale"]),
                lambda: qm.w8_matmul_plain(xx, dense, w["scale"]), 1e-2,
                _w8_path(qm, xx, dense), m=m, k=k, n=n, dtype="bfloat16",
                codes="dense")
            del dense
        del w
    w = _quantize_w(torch.randn(W8_STACK, generator=g, device=dev) * 0.02)
    for m in (4, 3968):
        x = torch.randn(m, W8_STACK[1], generator=g, device=dev)
        for dtype, bar in W8_BARS:
            xx = x.to(dtype)
            for li in (0, 11, 23):
                layer = torch.tensor(li, dtype=torch.int32, device=dev)
                results[("stacked", m, li, dtype)] = _w8_case(
                    "w8_matmul_stacked", qm.w8_matmul_stacked,
                    lambda: qm.w8_matmul_stacked(xx, w["q"], w["scale"], layer),
                    lambda: qm.w8_matmul_plain(xx, w["q"][li], w["scale"][li]),
                    bar, _w8_path(qm, xx, w["q"]), m=m, stack=list(W8_STACK),
                    layer=li, dtype=str(dtype).split(".")[-1])
    results["stacked_l2_cold"] = w8_l2_cold(dev, qm, w, g)
    return results


def w8_l2_cold(dev, qm, w, g) -> dict:
    """Decode as the model runs it: M = 4 over every layer of the (24, 2048,
    8192) stack in turn, one CUDA graph, so that each layer's 16.8 MB of
    codes comes from device memory (the stack is 403 MB, the L2 50 MB),
    beside layer 11 alone (its codes stay in L2 between replays)."""
    x = torch.randn(4, W8_STACK[1], generator=g, device=dev).bfloat16()
    layers = [torch.tensor(li, dtype=torch.int32, device=dev)
              for li in range(W8_STACK[0])]

    def every_layer():
        for layer in layers:
            qm.w8_matmul_stacked(x, w["q"], w["scale"], layer)

    cold = graph_ms(every_layer, calls=1) / len(layers)
    warm = graph_ms(lambda: qm.w8_matmul_stacked(x, w["q"], w["scale"],
                                                 layers[11]))
    result = dict(m=4, stack=list(W8_STACK), layer_ms_l2_cold=cold,
                  layer11_ms_l2_warm=warm)
    log("w8_l2_cold", **result)
    return result


W8_LIBRARY_SHAPES = ((4, 2048, 8192), (4, *W8_VOCAB), (3968, 2048, 8192),
                     (3968, *W8_VOCAB), (514, 1024, 4096), (514, 588, 1024))
# torch._weight_int8pack_mm crashes the process at K = 588 on the CPU: at
# the patch embedding's shape it runs in a child process (this script with
# ``--int8pack I``, I the shape's index), so that a fault ends the child,
# not this run
W8_LIBRARY_CHILD = ((514, 588, 1024),)


def int8pack_mm(x, w):
    """``torch._weight_int8pack_mm`` on ``w``'s codes, transposed to (N, K)
    with the scales in x's type (untimed)."""
    return functools.partial(torch._weight_int8pack_mm, x,
                             w["q"].t().contiguous(),
                             w["scale"].reshape(-1).to(x.dtype))


def phase_w8_library(dev, qm):
    """The W8 kernels' yardsticks at the main path's bf16 shapes (decode
    M = 4 over a decoder weight and the vocab head, prefill M = 3968):
    ``torch._weight_int8pack_mm`` where this torch runs it on the card, and
    a labelled reference that is not the same function (it reads a bf16
    copy of the weights): cuBLAS on the dequantised copy. Device times of
    CUDA graphs, as the kernels'."""
    results = {}
    for i, (m, k, n) in enumerate(W8_LIBRARY_SHAPES):
        x, w, ref = w8_library_inputs(dev, qm, i)
        deq = (w["q"].float() * w["scale"].reshape(1, -1)).bfloat16()
        result = (int8pack_child(i) if (m, k, n) in W8_LIBRARY_CHILD
                  else int8pack_time(x, w, ref))
        result["dequant_bf16_gemm_ms"] = graph_ms(lambda: x @ deq)
        results[(m, k, n)] = result
        log("w8_library", m=m, k=k, n=n, dtype="bfloat16", **result)
        del w, deq
    return results


def w8_library_inputs(dev, qm, i: int) -> tuple:
    """x, codes and the plain version's result at ``W8_LIBRARY_SHAPES[i]``,
    from a seed of their own."""
    from kosmosx_torch.utils.quantize import _quantize_w

    m, k, n = W8_LIBRARY_SHAPES[i]
    g = torch.Generator(device=dev).manual_seed(SEED + 14 + 100 * i)
    w = _quantize_w(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x = torch.randn(m, k, generator=g, device=dev).bfloat16()
    return x, w, qm.w8_matmul_plain(x, w["q"], w["scale"])


def int8pack_time(x, w, ref) -> dict:
    """``library_time`` of ``torch._weight_int8pack_mm`` on x and w's codes.
    At prefill the call takes some 0.14 s: few calls, and a launch is then
    no part of the time."""
    timer = graph_ms if x.shape[0] < 256 else functools.partial(
        graph_ms, calls=2, replays=1)
    return library_time(lambda: int8pack_mm(x, w), ref, 1e-2, timer=timer)


def int8pack_child(i: int) -> dict:
    """``int8pack_time`` at ``W8_LIBRARY_SHAPES[i]`` in a child process, on
    the same inputs; where the child dies, library_ms None with its exit
    code and last error line."""
    try:
        proc = subprocess.run([sys.executable, __file__, "--int8pack", str(i)],
                              capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        return {"library_ms": None, "library_note": "the child process "
                "timing it did not end within 300 s"}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode == 0 and lines:
        return json.loads(lines[-1])
    err = proc.stderr.strip().splitlines()
    return {"library_ms": None, "library_note": (
        f"the call ended its child process with exit code {proc.returncode}"
        f": {err[-1][:200] if err else 'no error output'}")}


def int8pack_main(i: int) -> int:
    """The child of ``int8pack_child``: prints ``int8pack_time``'s result
    at ``W8_LIBRARY_SHAPES[i]`` as one JSON object."""
    from kosmosx_torch.ops import quant_matmul as qm

    x, w, ref = w8_library_inputs(torch.device("cuda", 0), qm, i)
    print(json.dumps(int8pack_time(x, w, ref)))
    return 0


TILE_MAIN = (256, 1024, 64)  # the study's d64 g256, in the kernels line


def phase_tile_rate(dev, tr):
    """The tile-rate skeleton (S = Q K^T rounded to bf16, O = S V) against
    its plain version at (4, 1024, d) for d 64 and 128, and at each of the
    study's three shapes: error relative to the reference's largest value
    below 1e-2 (bf16 output rounding, and S roundings flipped where the fp32
    sum order differs), two launches bit-identical, the bmm pair within the
    same bar. Then the study's three configurations, kernel and bmm pair,
    with the launch counter set to 0 just before and read just after."""
    from kosmosx_torch.studies import tile_rate_study as study

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    checks = {}
    for shape in ((4, study.L, 64), (4, study.L, 128),
                  *((g_, study.L, d) for _, d, g_ in study.CONFIGS)):
        q, k, v = (torch.randn(shape, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        o = tr.tile_attention_skeleton(q, k, v)
        again = tr.tile_attention_skeleton(q, k, v)
        ref = tr.tile_attention_skeleton_plain(q, k, v)
        bmm = study.bmm_pair(q, k, v)
        torch.cuda.synchronize()
        err, bmm_err = rel_err(o, ref), rel_err(bmm, ref)
        same = torch.equal(o, again)
        checks[shape] = dict(
            max_abs_err=max_err(o, ref), max_rel_err=err,
            bmm_rel_err=bmm_err, bit_identical=same,
            ms=cuda_ms(lambda: tr.tile_attention_skeleton(q, k, v)),
            plain_ms=cuda_ms(lambda: tr.tile_attention_skeleton_plain(q, k, v),
                             iters=3),
            library_ms=cuda_ms(lambda: study.bmm_pair(q, k, v)))
        log("tile_rate", shape=list(shape), rel_bar=1e-2, **checks[shape])
        check(err < 1e-2, f"tile kernel {shape} relative error {err} >= 1e-2")
        check(same, f"tile kernel {shape}: two launches differ")
        check(bmm_err < 1e-2, f"bmm pair {shape} relative error {bmm_err}")
        if shape[0] > 4:  # the study's configurations
            check(checks[shape]["ms"] <= checks[shape]["library_ms"],
                  f"tile kernel {shape} slower than the bmm pair: "
                  f"{checks[shape]}")
        del q, k, v, o, again, ref, bmm
    tr.tile_attention_skeleton.launches = 0
    result = study.study(dev)
    launches = tr.tile_attention_skeleton.launches
    log("tile_rate_study", **result, launches=launches)
    check(launches > 0, f"tile kernel launches in the study: {launches}")
    return checks, launches


# (rows, width, parameter dtype) of the main path's LayerNorms: training's
# 4 images and 4 x 2046 positions with fp32 master parameters, scoring's 6
# and 6 x 2046 with bf16 ones, a decode step of 128 rows. Widths 2048 (the
# decoder) and 8192 (the FFN's sub-LN); 1024 in the CLIP ViT (257 tokens an
# image, the same rows as the resampler's media norm, which trains) and
# the resampler's latents (64 an image, trained)
LN_SHAPES = ((8184, 2048, torch.float32), (8184, 8192, torch.float32),
             (1028, 1024, torch.float32), (256, 1024, torch.float32),
             (12276, 2048, torch.bfloat16), (12276, 8192, torch.bfloat16),
             (1542, 1024, torch.bfloat16), (384, 1024, torch.bfloat16),
             (128, 2048, torch.bfloat16))


def bf16_ulps(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest gap in units of one bf16 ulp of the larger side, counted no
    finer than at 1/256 of the reference's largest value: an output near 0
    is a difference of O(1) terms, whose fp32 roundings (summed in another
    order by the plain version) exceed its own ulp."""
    a, ref = a.float(), ref.float()
    floor = max(ref.abs().max().item() / 256, 2.0 ** -126)
    big = torch.maximum(a.abs(), ref.abs()).clamp_min(floor)
    return ((a - ref).abs() / torch.exp2(torch.floor(torch.log2(big)) - 7)
            ).max().item()


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to return (no sync inside
    the timed calls): what a launch-bound caller pays."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def phase_layer_norm(dev, ln) -> dict:
    """The LayerNorm kernels at ``LN_SHAPES`` (bf16 x): errors against the
    plain versions, two backward runs bit-identical, one launch a call;
    forward and backward device times from CUDA-graph replays (x, y, dy and
    dx exceed the L2 at the decoder's shapes; the 1,024-wide and decode
    ones fit in it, so theirs are times from a warm L2), beside their
    bounds, back-to-back call times, the plain versions, the plain chain
    under autograd and the library's ``F.layer_norm`` and
    ``native_layer_norm_backward`` (on bf16 copies of fp32 parameters: it
    takes no mixed types); and the host time of an inference call, kernel
    and plain chain."""
    from kosmosx_torch.ops import roofline as rl

    fn = torch.nn.functional
    results = {}
    for rows, width, w_dtype in LN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(SEED + 21)
        x = (torch.randn(rows, width, generator=g, device=dev) * 2 + 3
             ).to(torch.bfloat16)
        scale = (torch.randn(width, generator=g, device=dev) * 0.5 + 1
                 ).to(w_dtype)
        bias = torch.randn(width, generator=g, device=dev).to(w_dtype)
        dy = torch.randn(rows, width, generator=g, device=dev
                         ).to(torch.bfloat16)
        before = (ln.layer_norm.launches, ln.layer_norm_bwd.launches)
        y, mean, rstd = ln.layer_norm_fwd(x, scale, bias)
        grads = ln.layer_norm_bwd(x, scale, mean, rstd, dy, bias=bias)
        launched = (ln.layer_norm.launches - before[0],
                    ln.layer_norm_bwd.launches - before[1])
        again = ln.layer_norm_bwd(x, scale, mean, rstd, dy, bias=bias)
        y_ref = ln.layer_norm_plain(x, scale, bias)
        ref = ln.layer_norm_bwd_plain(x, scale, mean, rstd, dy, bias=bias)
        torch.cuda.synchronize()
        r = dict(y_ulps=bf16_ulps(y, y_ref), y_max_abs_err=max_err(y, y_ref),
                 dx_rel_err=rel_err(grads[0], ref[0]),
                 bit_identical=all(torch.equal(a, b)
                                   for a, b in zip(grads, again)),
                 launches=launched)
        if w_dtype == torch.float32:
            r.update(dscale_rel_err=rel_err(grads[1], ref[1]),
                     dbias_rel_err=rel_err(grads[2], ref[2]))
        else:
            r.update(dscale_ulps=bf16_ulps(grads[1], ref[1]),
                     dbias_ulps=bf16_ulps(grads[2], ref[2]))
        w_item = scale.element_size()
        r["bound_ms"] = rl.bound(rl.layer_norm_fwd_work(
            rows, width, w_itemsize=w_item))[0]
        r["bwd_bound_ms"] = rl.bound(rl.layer_norm_bwd_work(
            rows, width, w_itemsize=w_item))[0]
        r["ms"] = graph_ms(lambda: ln.layer_norm_fwd(x, scale, bias))
        r["bwd_ms"] = graph_ms(lambda: ln.layer_norm_bwd(
            x, scale, mean, rstd, dy, bias=bias))
        r["call_ms"] = cuda_ms(lambda: ln.layer_norm_fwd(x, scale, bias))
        r["bwd_call_ms"] = cuda_ms(lambda: ln.layer_norm_bwd(
            x, scale, mean, rstd, dy, bias=bias))
        with torch.no_grad():
            r["host_us"] = host_us(lambda: ln.layer_norm(x, scale, bias))
            r["plain_host_us"] = host_us(
                lambda: ln.layer_norm_plain(x, scale, bias), calls=20)
        r["plain_ms"] = cuda_ms(lambda: ln.layer_norm_plain(x, scale, bias),
                                iters=3)
        r["plain_bwd_ms"] = cuda_ms(lambda: ln.layer_norm_bwd_plain(
            x, scale, mean, rstd, dy, bias=bias), iters=3)
        leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]

        def fwd_bwd(f):
            return lambda: torch.autograd.grad(f(*leaves), leaves, dy)

        r["chain_fwd_bwd_ms"] = cuda_ms(fwd_bwd(ln.layer_norm_plain),
                                        iters=3)
        r["kernel_fwd_bwd_ms"] = cuda_ms(fwd_bwd(ln.layer_norm))
        lib_w = scale.to(x.dtype), bias.to(x.dtype)
        r.update(library_time(
            lambda: lambda: fn.layer_norm(x, (width,), *lib_w, 1e-5),
            y_ref, 1e-2))

        def native_bwd():
            _, m, s = torch.ops.aten.native_layer_norm(x, [width], *lib_w,
                                                       1e-5)
            return lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [width], m, s, *lib_w, [True, True, True])

        lib_bwd = library_time(native_bwd, ref[0], 1e-2,
                               pick=lambda out: out[0])
        r.update({f"bwd_{k}": v for k, v in lib_bwd.items()})
        results[(rows, width, str(w_dtype).split(".")[-1])] = r
        log("layer_norm", shape=[rows, width], params=str(w_dtype), **r)
        check(r["y_ulps"] <= 1, f"layer_norm {rows}x{width}: y {r['y_ulps']}"
              f" bf16 ulps from the plain version")
        check(r["dx_rel_err"] <= 1e-2, f"layer_norm {rows}x{width}: dx "
              f"relative error {r['dx_rel_err']}")
        for k in ("dscale", "dbias"):
            if w_dtype == torch.float32:
                check(r[f"{k}_rel_err"] <= 1e-3, f"layer_norm {k}: {r}")
            else:
                check(r[f"{k}_ulps"] <= 1, f"layer_norm {k}: {r}")
        check(r["bit_identical"], f"layer_norm {rows}x{width}: two backward "
              f"runs differ")
        check(launched == (1, 1), f"layer_norm launches {launched}")
        del x, y, dy, grads, again, ref, y_ref, leaves, lib_w
    return results


# the LFM2 cell's shapes (perfbench/traffic/score-long-b4.json): 4 rows of
# 8,192 positions, hidden 2048, 32 query and 8 key/value heads of 64, 64
# experts of 1,536, top-4
LFM2_BATCH, LFM2_LEN, LFM2_D = 4, 8192, 2048
LFM2_HEADS, LFM2_KV, LFM2_EXPERTS, LFM2_FFN, LFM2_TOPK = 32, 8, 64, 1536, 4
LFM2_ATTN_LAYERS = 10


def lfm2_zipf_offsets(dev, g, assignments: int, experts: int, s: float = 1.1):
    """Running end offsets (int32) of ``assignments`` rows spread over the
    experts by Zipf's law with exponent ``s`` (the heaviest expert about a
    fifth of the rows), in a seeded order of the experts."""
    p = torch.arange(1, experts + 1, dtype=torch.float64).pow(-s)
    p = p[torch.randperm(experts, generator=torch.Generator().manual_seed(
        SEED + 31))]
    ids = torch.multinomial(p.float().to(dev), assignments, replacement=True,
                            generator=g)
    counts = torch.bincount(ids, minlength=experts)
    return counts.cumsum(0).to(torch.int32), counts


def lfm2_entry(name, r) -> dict:
    r = dict(r)
    r["share_of_bound"] = r["bound_ms"] / r["ms"] if r.get("ms") else None
    log("lfm2", kernel=name, **r)
    return {"name": name, "route": "cuda", **r}


def gqa_attention_blocked(q, k, v, scale: float, block: int = 512):
    """Causal attention in fp32 over (B, H, L, d) queries and (B, Hkv, L, d)
    keys and values, query head h reading key/value head h // (H / Hkv), in
    blocks of ``block`` query rows (the full (B, H, L, L) scores do not fit
    at the LFM2 cell's shape), in q's dtype."""
    group = q.shape[1] // k.shape[1]
    k = k.float().repeat_interleave(group, dim=1)
    v = v.float().repeat_interleave(group, dim=1)
    length = q.shape[2]
    out = torch.empty_like(q)
    for q0 in range(0, length, block):
        q1 = min(q0 + block, length)
        s = (q[:, :, q0:q1].float() @ k[:, :, :q1].transpose(-1, -2)) * scale
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        cols = torch.arange(q1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        out[:, :, q0:q1] = (torch.softmax(s, dim=-1) @ v[:, :, :q1]).to(q.dtype)
        del s
    return out


def phase_lfm2(dev) -> list:
    """The LFM2 cell's kernels at its shapes: each held to its plain
    version (the GQA forward to plain attention in blocks of query rows),
    one launch a call, device times beside the bounds of
    ``perfbench/roofline_lfm2.py``, the plain versions and, where one
    PyTorch call computes the same function, its time."""
    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.ops import grouped_moe as gm
    from kosmosx_torch.ops import layer_norm as ln
    from kosmosx_torch.ops import qk_rope
    from kosmosx_torch.ops import short_conv as sc

    from perfbench import roofline, roofline_lfm2 as rl

    def bound_ms(work):
        return roofline.bound_s(work) * 1e3

    fn = torch.nn.functional
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    t, d = LFM2_BATCH * LFM2_LEN, LFM2_D
    out = []

    # the gated short convolution
    bcx = torch.randn(t, 3 * d, generator=g, device=dev).to(bf)
    taps = (torch.rand(d, 3, generator=g, device=dev) - 0.5).to(bf)
    before = sc.short_conv.launches
    y = sc.short_conv(bcx, taps, LFM2_LEN)
    launches = sc.short_conv.launches - before
    want = sc.short_conv_plain(bcx, taps, LFM2_LEN)
    torch.cuda.synchronize()
    r = dict(shape=[t, d], ulps=bf16_ulps(y, want), launches=launches,
             ms=cuda_ms(lambda: sc.short_conv(bcx, taps, LFM2_LEN)),
             plain_ms=cuda_ms(lambda: sc.short_conv_plain(bcx, taps,
                                                          LFM2_LEN), iters=3),
             bound_ms=bound_ms(rl.short_conv_work(t, d, 3, 2)))
    out.append(lfm2_entry("short_conv", r))
    check(r["ulps"] <= 1 and launches == 1, f"short_conv: {r}")
    check(r["ms"] <= 1.5 * r["bound_ms"],
          f"short_conv: {r['ms']} ms, over 1.5x its bound {r['bound_ms']}")
    del bcx, y, want

    # RMSNorm at the decoder's rows (the fp32 residual stream normalised
    # into bf16) and at the QK-norm's 64-wide bf16 rows
    for rows, width, x_dtype in ((t, d, torch.float32), (t * 40, 64, bf)):
        x = (torch.randn(rows, width, generator=g, device=dev) * 2
             ).to(x_dtype)
        w = (torch.rand(width, generator=g, device=dev) + 0.5).to(bf)
        before = ln.rms_norm.launches
        y = ln.rms_norm(x, w, out_dtype=bf)
        launches = ln.rms_norm.launches - before
        want = ln.rms_norm_plain(x, w, out_dtype=bf)
        torch.cuda.synchronize()
        r = dict(shape=[rows, width], x=str(x_dtype), ulps=bf16_ulps(y, want),
                 launches=launches,
                 ms=cuda_ms(lambda: ln.rms_norm(x, w, out_dtype=bf)),
                 plain_ms=cuda_ms(lambda: ln.rms_norm_plain(
                     x, w, out_dtype=bf), iters=3),
                 bound_ms=bound_ms(rl.rms_norm_work(
                     rows, width, x.element_size(), 2)))
        r.update(library_time(lambda: lambda: fn.rms_norm(
            x, (width,), w.to(x_dtype), 1e-5).to(bf), want, 1e-2))
        out.append(lfm2_entry("rms_norm", r))
        check(r["ulps"] <= 1 and launches == 1, f"rms_norm: {r}")
        del x, y, want

    # QK-norm and RoPE, then the GQA flash forward
    nh = LFM2_HEADS + 2 * LFM2_KV
    qkv = torch.randn(t, nh * 64, generator=g, device=dev).to(bf)
    qs = (torch.rand(64, generator=g, device=dev) + 1.5).to(bf)
    ks = (torch.rand(64, generator=g, device=dev) + 1.5).to(bf)
    kw = dict(batch=LFM2_BATCH, heads=LFM2_HEADS, kv_heads=LFM2_KV,
              theta=1e6)
    before = qk_rope.qk_norm_rope.launches
    q, k, v = qk_rope.qk_norm_rope(qkv, qs, ks, **kw)
    launches = qk_rope.qk_norm_rope.launches - before
    want = qk_rope.qk_norm_rope_plain(qkv, qs, ks, **kw)
    torch.cuda.synchronize()
    r = dict(shape=[t, nh, 64],
             ulps=max(bf16_ulps(a, b) for a, b in zip((q, k, v), want)),
             launches=launches,
             ms=cuda_ms(lambda: qk_rope.qk_norm_rope(qkv, qs, ks, **kw)),
             plain_ms=cuda_ms(lambda: qk_rope.qk_norm_rope_plain(
                 qkv, qs, ks, **kw), iters=3),
             bound_ms=bound_ms(rl.qk_norm_rope_work(
                 t, LFM2_HEADS, LFM2_KV, LFM2_LEN, 2)))
    out.append(lfm2_entry("qk_norm_rope", r))
    check(r["ulps"] <= 1 and launches == 1, f"qk_norm_rope: {r}")
    del qkv, want
    scale = 0.125
    before = fa.flash_attention.launches
    o = fa.flash_attention_fwd(q, k, v, causal=True, sm_scale=scale)[0]
    launches = fa.flash_attention.launches - before
    want = gqa_attention_blocked(q, k, v, scale)
    torch.cuda.synchronize()
    r = dict(shape=[LFM2_BATCH, LFM2_HEADS, LFM2_KV, LFM2_LEN, 64],
             err=max_err(o, want), launches=launches,
             ms=cuda_ms(lambda: fa.flash_attention_fwd(
                 q, k, v, causal=True, sm_scale=scale)),
             bound_ms=bound_ms(rl.flash_fwd_gqa_work(
                 LFM2_BATCH, LFM2_HEADS, LFM2_KV, LFM2_LEN, LFM2_LEN, 64,
                 causal=True)))
    r.update(library_time(lambda: lambda: fn.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale, enable_gqa=True), o, 2e-2))
    out.append(lfm2_entry("flash_fwd_gqa", r))
    check(r["err"] <= 2e-2 and launches == 1, f"flash_fwd_gqa: {r}")
    del q, k, v, o, want

    # the experts' grouped products at top-4 of 32,768 tokens, Zipf load
    m = t * LFM2_TOPK
    offsets, counts = lfm2_zipf_offsets(dev, g, m, LFM2_EXPERTS)
    x = torch.randn(m, d, generator=g, device=dev).to(bf)
    w13 = (torch.randn(LFM2_EXPERTS, d, 2 * LFM2_FFN, generator=g,
                       device=dev) * d ** -0.5).to(bf)
    w2 = (torch.randn(LFM2_EXPERTS, LFM2_FFN, d, generator=g, device=dev)
          * LFM2_FFN ** -0.5).to(bf)
    routing = gm.Routing(None, None, None, counts.to(torch.int32), offsets,
                         x)
    y = gm.expert_ffn(routing, w13, w2)
    ends = offsets.tolist()

    def loop():
        res, start = [], 0
        for e, end in enumerate(ends):
            h = x[start:end] @ w13[e]
            res.append((fn.silu(h[:, :LFM2_FFN]) * h[:, LFM2_FFN:]) @ w2[e])
            start = end
        return torch.cat(res)

    want = loop()
    torch.cuda.synchronize()
    r = dict(shape=[m, LFM2_EXPERTS, d, LFM2_FFN],
             largest_expert=int(counts.max()), rel_err=rel_err(y, want),
             ms=cuda_ms(lambda: gm.expert_ffn(routing, w13, w2)),
             plain_ms=cuda_ms(loop, iters=3),
             bound_ms=bound_ms(rl.moe_experts_work(m, LFM2_EXPERTS, d,
                                                   LFM2_FFN, 2)))
    out.append(lfm2_entry("moe_experts", r))
    check(r["rel_err"] <= 2e-2, f"moe_experts: {r}")
    del x, y, want, w13, w2, routing

    # routing and the combine at the cell's tokens, into the fp32 stream
    x = torch.randn(t, d, generator=g, device=dev).to(bf)
    res = torch.randn(t, d, generator=g, device=dev)
    wr = (torch.randn(d, LFM2_EXPERTS, generator=g, device=dev)
          * d ** -0.5).to(bf)
    bias = torch.randn(LFM2_EXPERTS, generator=g, device=dev) * 0.1
    routing = gm.route(x, wr, bias, LFM2_TOPK)
    ye = torch.randn(m, d, generator=g, device=dev).to(bf)
    before = gm.combine.launches
    z = gm.combine(res, ye, routing)
    launches = gm.combine.launches - before
    want = gm.combine_plain(res, ye, routing.pos, routing.gates)
    torch.cuda.synchronize()
    r = dict(shape=[t, d, LFM2_TOPK], rel_err=rel_err(z, want),
             launches=launches,
             route_ms=cuda_ms(lambda: gm.route(x, wr, bias, LFM2_TOPK)),
             ms=cuda_ms(lambda: gm.combine(res, ye, routing)),
             plain_ms=cuda_ms(lambda: gm.combine_plain(
                 res, ye, routing.pos, routing.gates), iters=3),
             bound_ms=bound_ms((0, m * d * 2 + 2 * t * d * 4
                                + t * LFM2_TOPK * 8)))
    out.append(lfm2_entry("moe_combine", r))
    check(r["rel_err"] <= 1e-5 and launches == 1, f"moe_combine: {r}")
    return out


def phase_lfm2_forward(dev) -> dict:
    """LFM2-24B-A2B's forward on the main path at the cell's size:
    ``Lfm2.apply`` under ``inference_mode`` on 4 x 8,192 Zipf token ids,
    from the benchmark's seeded bf16 weights (``perfbench/drivers/
    score_lm.py`` builds the model and draws the ids as the cell does),
    every launch counter set to 0 just before it. One forward launches the
    short conv once a conv layer (30), RMSNorm twice a layer and once for
    the final norm (81), QK-norm/RoPE and the GQA flash forward once an
    attention layer (10 each), the combine once an expert layer (38), and
    no LayerNorm and no xPos rotation; its logits are (4, 8192, 65536) and
    finite. Then the forward is timed."""
    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.ops import grouped_moe as gm
    from kosmosx_torch.ops import layer_norm as ln
    from kosmosx_torch.ops import qk_rope
    from kosmosx_torch.ops import short_conv as sc

    from perfbench.drivers import score_lm

    root = Path(__file__).resolve().parent
    cfg = json.loads((root / "perfbench" / "configs" /
                      "lfm2-24b-a2b.json").read_text())
    traffic = json.loads((root / "perfbench" / "traffic" /
                          "score-long-b4.json").read_text())
    model, flat = score_lm.build(cfg, SEED + 32, dev)
    tokens = score_lm.Inputs(cfg, traffic, SEED + 32, dev).next()
    kinds = cfg["layer_types"]
    n_layers, n_attn = len(kinds), kinds.count("full_attention")
    want = {"short_conv": kinds.count("conv"), "rms_norm": 2 * n_layers + 1,
            "qk_norm_rope": n_attn, "flash_attention": n_attn,
            "combine": n_layers - cfg["num_dense_layers"],
            "layer_norm": 0, "flash_fwd_prep": 0}
    counters = {"short_conv": sc.short_conv, "rms_norm": ln.rms_norm,
                "qk_norm_rope": qk_rope.qk_norm_rope,
                "flash_attention": fa.flash_attention, "combine": gm.combine,
                "layer_norm": ln.layer_norm,
                "flash_fwd_prep": fa.flash_fwd_prep}
    with torch.inference_mode():
        for f in counters.values():
            f.launches = 0
        logits = model.apply(tokens)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items()}
        shape = list(logits.shape)
        finite = bool(torch.isfinite(logits).all())
        del logits
        ms = cuda_ms(lambda: model.apply(tokens), iters=3)
    r = dict(shape=shape, finite=finite, launches=launches, want=want,
             forward_ms=ms,
             memory_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    log("lfm2_forward", **r)
    check(launches == want, f"LFM2 forward launches {launches}, want {want}")
    check(shape == [traffic["batch"], traffic["length"], cfg["vocab_size"]]
          and finite, f"LFM2 logits {shape}, finite {finite}")
    del model, flat, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return r


LION_STEPS = 3        # steps held bit for bit against the leaf path
LION_KIND_LEAVES = (16, 32)


def phase_lion(dev, kx) -> dict:
    """Phase 4e: the Lion kernels (``ops/lion.py``) at the training cell's
    leaf set: the ``kosmosx`` config's trainable leaves in fp32 (CLIP
    frozen), the multiway B experts without gradients, the cell's
    hyperparameters (lr 1e-4, decay 0.1 on the masked leaves, betas 0.9 and
    0.95, clipping at 1.0). Three steps of ``Optimizer.step`` on the kernels
    against the leaf path given the kernels' norm: p and m bit-identical,
    three launches a step; the norm against a float64 norm. Then each path
    timed: the kernels' step by CUDA events beside its bound (each
    parameter and moment read and written once, each gradient read once),
    the leaf path (the global norm and ``_step_leaves``, what a step on the
    card ran before the kernels) by CUDA events, both under the profiler
    (launches, device time) and by the host time ``Optimizer.step`` takes
    to return; and, for the kinds that keep the leaf path, the launches a
    step makes over 16 and 32 leaves."""
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.ops import lion
    from kosmosx_torch.ops import roofline as rl
    from kosmosx_torch.train import optim
    from kosmosx_torch.train.trainer import split_frozen

    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    model = Kosmos(train_config(kx), generator=g, device=dev)
    params = {n: p.detach() for n, p in split_frozen(model, ("clip",))[0]
              .items()}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    grads = {n: None if ".B." in n else
             torch.randn(p.shape, generator=g, device=dev) * 1e-4
             for n, p in params.items()}
    sched = optim.make_schedule("constant", 1e-4, 10, warmup_steps=0)
    ref_params = {n: p.clone() for n, p in params.items()}
    fused = optim.make_optimizer("lion", sched, params)
    ref = optim.make_optimizer("lion", sched, ref_params)
    before = (lion.lion.launches, lion.lion.leaves)
    norms = []
    for _ in range(LION_STEPS):
        norm = fused.step(grads)
        ref._step_leaves(grads, norm.clone(), sched(ref.count), ref.count)
        ref.count += 1
        norms.append(norm)
    torch.cuda.synchronize()
    counts = (lion.lion.launches - before[0], lion.lion.leaves - before[1])
    bits = all(torch.equal(params[n], ref_params[n])
               and torch.equal(fused.mu[n], ref.mu[n]) for n in params)
    exact = math.sqrt(sum(float(t.double().square().sum())
                          for t in grads.values() if t is not None))
    norm_rel_err = abs(float(norms[0]) - exact) / exact
    norms_same = all(torch.equal(norms[0], x) for x in norms[1:])
    moved = sum(not torch.equal(fused.mu[n], torch.zeros_like(fused.mu[n]))
                for n in params)
    with_grad = [t for t in grads.values() if t is not None]
    n_params = sum(p.numel() for p in params.values())
    work = rl.lion_work(n_params, 4 * n_params, 4 * n_params,
                        sum(t.numel() for t in with_grad),
                        4 * sum(t.numel() for t in with_grad))
    bound_ms, bound_by = rl.bound(work, rl.H100_FP32_FLOPS)

    def leaf_step():
        norm = optim.global_norm({n: grads.get(n) for n in ref.order})
        ref._step_leaves(grads, norm, sched(ref.count), ref.count)

    r = dict(leaves=len(params), with_grad=len(with_grad), params=n_params,
             steps=LION_STEPS, launches_per_step=counts[0] / LION_STEPS,
             leaves_per_step=counts[1] / LION_STEPS, bit_identical=bits,
             norm=float(norms[0]), norm_rel_err=norm_rel_err,
             norm_repeats=norms_same, moments_moved=moved,
             bytes=work[1], bound_ms=bound_ms, bound_by=bound_by)
    r["ms"] = cuda_ms(lambda: fused.step(grads), iters=10)
    r["norm_ms"] = cuda_ms(lambda: fused.norm(grads), iters=10)
    r["plain_ms"] = cuda_ms(leaf_step, iters=3)
    r["step"] = step_reading(lambda: fused.step(grads))
    r["plain_step"] = step_reading(leaf_step)
    r["host_us"] = host_us(lambda: fused.step(grads), calls=20)
    r["plain_host_us"] = host_us(leaf_step, calls=3)
    r["share_of_bound"] = bound_ms / r["ms"]
    del fused, ref, params, ref_params, grads, norms
    gc.collect()
    torch.cuda.empty_cache()
    # the launches of the kinds that keep the leaf path
    kinds = {}
    for name in optim.OPTIMIZERS:
        counted = []
        for n_leaves in LION_KIND_LEAVES:
            ps = {f"l{i}.w": torch.randn(64, 64, generator=g, device=dev)
                  for i in range(n_leaves)}
            gs = {n: torch.randn(64, 64, generator=g, device=dev) for n in ps}
            opt = optim.make_optimizer(name, sched, ps)
            opt.step(gs)
            counted.append(step_reading(lambda: opt.step(gs))["launches"])
        small, large = LION_KIND_LEAVES
        per_leaf = (counted[1] - counted[0]) / (large - small)
        kinds[name] = {"launches": dict(zip(LION_KIND_LEAVES, counted)),
                       "per_leaf": per_leaf,
                       "fixed": counted[0] - per_leaf * small}
    r["kinds"] = kinds
    log("lion", **r)
    check(bits, "the Lion kernels' p and m differ from the leaf path's")
    check(counts == (3 * LION_STEPS, LION_STEPS * r["leaves"]),
          f"Lion launches and leaves {counts}: three launches a step")
    check(norm_rel_err <= 1e-6 and norms_same,
          f"Lion norm {float(r['norm'])}: {norm_rel_err} from float64")
    check(moved == r["with_grad"], f"{moved} moments moved, "
          f"{r['with_grad']} leaves got a gradient")
    return {"name": "lion", "route": "cuda",
            "source": "kosmosx_torch/csrc/optim.cu",
            "replaces": "no Pallas kernel (optax, kosmosx_tpu/train/optim.py"
                        ":127-162)",
            "shape": [r["leaves"], n_params],
            "launches_per_call": r["launches_per_step"],
            **{k: r[k] for k in ("ms", "norm_ms", "bound_ms", "plain_ms",
                                 "host_us", "plain_host_us",
                                 "share_of_bound")}}


def layer_norm_entries(results) -> list:
    """The kernels line's LayerNorm rows: the forward and the backward at
    each main-path shape."""
    out = []
    for (rows, width, params), r in results.items():
        out.append({
            "name": "layer_norm", "route": "cuda",
            "source": "kosmosx_torch/csrc/layer_norm.cu",
            "replaces": "no Pallas kernel (jnp, kosmosx_tpu/nn/layers.py:145)",
            "shape": [rows, width], "params": params,
            "launches_per_call": list(r["launches"]),
            **{k: r.get(k) for k in (
                "ms", "call_ms", "bound_ms", "plain_ms", "library_ms",
                "bwd_ms", "bwd_call_ms", "bwd_bound_ms", "plain_bwd_ms",
                "bwd_library_ms", "chain_fwd_bwd_ms", "kernel_fwd_bwd_ms",
                "host_us", "plain_host_us")}})
    return out


def w8_model(model, cfg):
    """A W8 copy of ``model`` in the stacked layout (``scan_layers=True``)."""
    from kosmosx_torch.utils.quantize import quantize_params_w8

    scan = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, scan_layers=True))
    model.config = scan
    try:
        return quantize_params_w8(model), scan
    finally:
        model.config = cfg


def phase_w8_reference(dev, kx, qm):
    """Full width, depth cut to 2 decoder and 2 ViT layers, fp32, W8 in the
    stacked layout: the W8 kernels against the plain expression
    (``set_w8_kernel("off")``) on the same codes."""
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.nn import layers

    c = kx.core.config
    cfg = c.KosmosConfig(
        decoder=c.MagnetoConfig(layers=2, dropout=0.0, attention_dropout=0.0),
        vision=c.VisionConfig(layers=2))
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    model, cfg = w8_model(Kosmos(cfg, generator=g, device=dev), cfg)
    tokens = torch.randint(4, cfg.decoder.vocab_size, (2, 448), generator=g,
                           device=dev)
    images = pixels(2, g, dev)
    qm.w8_matmul.launches = qm.w8_matmul_stacked.launches = 0
    with torch.inference_mode():
        out = model.apply(tokens, images)
        launches = {"w8_matmul": qm.w8_matmul.launches,
                    "w8_matmul_stacked": qm.w8_matmul_stacked.launches}
        layers.set_w8_kernel("off")
        try:
            ref = model.apply(tokens, images)
        finally:
            layers.set_w8_kernel("auto")
    err = max_err(out, ref)
    log("w8_reference", layers=2, dtype="float32", positions=512,
        max_abs_err=err, bar=1e-3, launches=launches)
    check(err < 1e-3, f"W8 kernel vs plain path logits error {err}")
    check(launches["w8_matmul"] > 0 and launches["w8_matmul_stacked"]
          == 6 * cfg.decoder.layers, f"W8 launches {launches}")


def phase_w8_forward(dev, kx, fa, qm, model, cfg):
    """The flagship W8 ``Kosmos.apply`` at 2 x (1920 + 64) positions, bf16,
    against the bf16 model it was quantized from."""
    from kosmosx_torch.utils.quantize import w8_param_bytes

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    tokens = torch.randint(4, cfg.decoder.vocab_size, (2, 1920), generator=g,
                           device=dev)
    images = pixels(2, g, dev)
    with torch.inference_mode():
        ref = model.apply(tokens, images).float()
    bf16_bytes = w8_param_bytes(model)
    t0 = time.perf_counter()
    w8, w8_cfg = w8_model(model, cfg)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    w8_bytes = w8_param_bytes(w8)
    runs = 3
    with torch.inference_mode():
        w8.apply(tokens, images)  # warm-up
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        qm.w8_matmul.launches = qm.w8_matmul_stacked.launches = 0
        fwd_s = []
        with vocab_head_paths(qm, cfg) as vocab:
            for _ in range(runs):
                t0 = time.perf_counter()
                logits = w8.apply(tokens, images)
                torch.cuda.synchronize()
                fwd_s.append(time.perf_counter() - t0)
    launches = {"flash": fa.flash_attention.launches,
                "w8_matmul": qm.w8_matmul.launches,
                "w8_matmul_stacked": qm.w8_matmul_stacked.launches}
    finite = bool(torch.isfinite(logits).all())
    logits = logits.float()
    rel = ((logits - ref).norm() / ref.norm()).item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log("w8_forward", quantize_s=quantize_s, forward_s=fwd_s,
        logits_shape=list(logits.shape), finite=finite, launches=launches,
        vocab_head_paths=vocab, rel_frobenius_vs_bf16=rel,
        argmax_agreement=agree,
        param_bytes=w8_bytes, bf16_param_bytes=bf16_bytes,
        bytes_ratio=w8_bytes / bf16_bytes)
    layers = cfg.decoder.layers
    check(tuple(logits.shape) == (2, 1984, cfg.decoder.vocab_size),
          f"W8 logits shape {tuple(logits.shape)}")
    check(finite, "W8 flagship logits are finite")
    check(launches["flash"] == runs * layers, f"flash launches {launches}")
    check(launches["w8_matmul"] > 0 and launches["w8_matmul_stacked"]
          == runs * 6 * layers, f"W8 launches {launches}")
    check(vocab == {"hopper": runs}, f"W8 forward vocab head paths {vocab}: "
                                     f"one Hopper launch per run")
    check(rel < 0.1, f"W8 vs bf16 logits relative Frobenius error {rel}")
    check(w8_bytes < 0.6 * bf16_bytes, f"W8 bytes {w8_bytes} vs bf16 "
                                       f"{bf16_bytes}")
    del logits, ref
    return w8, w8_cfg


@contextlib.contextmanager
def vocab_head_paths(qm, cfg):
    """Within the block, the kernel each CUDA call of the 2-D W8 wrapper on
    the vocab head's (K, N) codes took, counted by kernel into the dict it
    yields: ``qm._launch``, which both W8 wrappers call and which returns
    the kernel it ran, is wrapped for the block's span."""
    shape = (cfg.decoder.embed_dim, cfg.decoder.vocab_size)
    paths = collections.Counter()
    inner = qm._launch

    def traced(x2, q, scale, n, layer=None):
        out, path = inner(x2, q, scale, n, layer)
        if layer is None and tuple(q.shape) == shape:
            paths[path] += 1
        return out, path

    qm._launch = traced
    try:
        yield paths
    finally:
        qm._launch = inner


def phase_w8_generate(dev, fa, da, qm, w8, cfg, bf16):
    """Phase 6's requests on the W8 model, beside phase 6's bf16 run."""
    with vocab_head_paths(qm, cfg) as vocab:
        result = drive_generation(dev, w8, cfg, {
            "flash": fa.flash_attention, "decode": da.decode_attention,
            "w8_matmul": qm.w8_matmul,
            "w8_matmul_stacked": qm.w8_matmul_stacked})
    first = result.pop("tokens")
    launches = result["launches"]
    keys = ("prefill_s", "decode_step_ms", "tok_per_s", "peak_mem_bytes")
    log("w8_generate", **result, tokens_row0=first[0, :8].tolist(),
        bf16={k: bf16[k] for k in keys},
        token_agreement_vs_bf16=(first == bf16["tokens"]).float().mean().item())
    # the 2-D wrapper takes the Hopper kernel for the ViT's and the
    # resampler's projections and the vocab head, and the mma.sync kernel
    # for the patch embedding; the stacked one the Hopper kernel only
    launches["w8_matmul.mma"] = (launches["w8_matmul"]
                                 - launches["w8_matmul.hopper"])
    log("w8_generate_paths", vocab_head_paths=vocab,
        **{k: v for k, v in launches.items() if k.startswith("w8")})
    check(all(v > 0 for v in launches.values()),
          f"every kernel launched in W8 generation: {launches}")
    check(set(vocab) == {"hopper"},
          f"W8 generation's vocab head paths {vocab}: the Hopper kernel only")
    check(launches["w8_matmul_stacked.hopper"]
          == launches["w8_matmul_stacked"],
          f"every stacked W8 launch takes the Hopper kernel: {launches}")
    return launches


# -- phases 6i-6l: the serving engine ----------------------------------------

ENGINE_TEXT_LENGTHS = (64, 480)   # 6i's text prompts are drawn in this range
ENGINE_PREFIX = 128               # 6i's registered copy prefix
NEAR_TIE = 1e-4                   # 6j: a top-2 logit gap below this is a tie


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))] if xs else 0.0


def drive_engine(eng, work, on_step=None) -> dict:
    """Serve ``work`` (dicts of ``submit`` keyword arguments; ``at`` the
    step before which each is submitted, ``None``: when a slot is free) on
    ``eng`` to the end, tracing off: the handles, the host-clock readings
    of each request (submit to first committed token, and the gap per
    token between commits) and the (padded width, layers) of each
    whole-prompt prefill, as ``eng._prefill_span`` is called for it."""
    handles, t_submit, t_first, gaps = [], {}, {}, []
    seen = {}
    queue = list(work)
    step = 0
    widths = []
    prefill_span = eng._prefill_span

    def counted(width, real, cfg, *args, **kwargs):
        widths.append((min(int(width), eng.cache_len), cfg.layers))
        return prefill_span(width, real, cfg, *args, **kwargs)

    eng._prefill_span = counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def submit_due():
        while queue and (queue[0].get("at") is not None
                         and queue[0]["at"] <= step
                         or queue[0].get("at") is None
                         and eng.num_active + len(eng.pending)
                         < eng.scfg.max_batch):
            kw = {k: v for k, v in queue.pop(0).items() if k != "at"}
            h = eng.submit(**kw)
            t_submit[h.id] = time.perf_counter()
            seen[h.id] = (0, t_submit[h.id])
            handles.append(h)

    while queue or eng.pending or eng.num_active or eng._inflight \
            or eng._outstanding:
        submit_due()
        eng.step()
        step += 1
        now = time.perf_counter()
        for h in handles:
            n, t_last = seen[h.id]
            if len(h.tokens) > n:
                if n == 0:
                    t_first[h.id] = now
                else:
                    gaps += [(now - t_last) / (len(h.tokens) - n)] * (
                        len(h.tokens) - n)
                seen[h.id] = (len(h.tokens), now)
        if on_step is not None:
            on_step(eng, handles, step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng._prefill_span   # the method again
    tokens = sum(len(h.tokens) for h in handles)
    ttft = {h.id: t_first[h.id] - t_submit[h.id] for h in handles
            if h.id in t_first}
    return dict(handles=handles, wall_s=wall, tokens=tokens,
                tok_per_s=tokens / wall, ttft_s=ttft,
                ttft_p50_s=percentile(list(ttft.values()), 0.5),
                inter_token_p50_s=percentile(gaps, 0.5),
                inter_token_p99_s=percentile(gaps, 0.99), steps=step,
                prefill_widths=widths)


def engine_launch_checks(eng, widths, launches: dict, layers: int) -> dict:
    """The decode kernel once per layer and decode dispatch since
    ``reset_counters``, the flash forward once per layer and whole-prompt
    prefill of 256 or more positions (``widths``: ``drive_engine``'s
    ``prefill_widths``)."""
    long = sum(1 for w, n in widths if w >= 256)
    want = {"decode": layers * eng.steps,
            "flash": sum(n for w, n in widths if w >= 256)}
    return dict(launches=launches, want=want, decode_dispatches=eng.steps,
                prefills=len(widths), long_prefills=long)


def phase_engine(dev, fa, da, model, cfg) -> dict:
    """Phase 6i: the serving engine at full width, bf16: phase 5's flagship
    with ``decode_attn_kernel=True`` under ``ServeEngine(max_batch=8,
    max_prompt_len=512, max_len=1024, sync_lag=4)``; 16 requests (4
    multimodal of phase 6, 12 text of 64-480 tokens from the seed, budgets
    of 32-64 tokens, no EOS): 8 text at once (one batched admission of 8),
    the rest as slots free; one with temperature 0.8 and top-k 50, one
    cancelled after 8 tokens, one a hit on a registered copy prefix of 128
    tokens."""
    from kosmosx_torch.generate.sampler import SamplingConfig
    from kosmosx_torch.serve import ServeConfig, ServeEngine

    ecfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, decode_attn_kernel=True))
    vocab = cfg.decoder.vocab_size
    g = torch.Generator().manual_seed(SEED + 20)
    eng = ServeEngine(model, ecfg.decoder,
                      ServeConfig(max_batch=8, max_prompt_len=512,
                                  max_len=1024, sync_lag=4),
                      SamplingConfig(greedy=True), kosmos_cfg=ecfg,
                      device=dev)
    lo, hi = ENGINE_TEXT_LENGTHS
    lengths = torch.randint(lo, hi + 1, (12,), generator=g).tolist()
    budgets = torch.randint(32, 65, (16,), generator=g).tolist()
    texts = [torch.randint(4, vocab, (n,), generator=g).tolist()
             for n in lengths]
    prefix = torch.randint(4, vocab, (ENGINE_PREFIX,), generator=g).tolist()
    texts[9] = prefix + texts[9][:max(1, lengths[9] - ENGINE_PREFIX)]
    mm_tokens, mm_lengths, mm_images = generation_requests(dev, cfg)
    work = [dict(prompt=t, max_new_tokens=b, at=0)
            for t, b in zip(texts[:8], budgets[:8])]
    work += [dict(prompt=t, max_new_tokens=b)
             for t, b in zip(texts[8:], budgets[8:12])]
    work[10].update(temperature=0.8, top_k=50)
    work += [dict(prompt=mm_tokens[i, :int(mm_lengths[i])].tolist(),
                  images=mm_images[i:i + 1], max_new_tokens=b)
             for i, b in enumerate(budgets[12:])]
    cancel_at = 8
    cancelled = {}

    def cancel_one(eng, handles, step):
        if not cancelled and len(handles) > 1 and \
                len(handles[1].tokens) >= cancel_at:
            cancelled["id"] = handles[1].id
            cancelled["tokens_at_cancel"] = len(handles[1].tokens)
            eng.cancel(handles[1])

    with torch.inference_mode():
        eng.register_prefix(prefix)
    gc.collect()
    torch.cuda.synchronize()
    eng.reset_counters()
    fa.flash_attention.launches = da.decode_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = drive_engine(eng, work, cancel_one)
    launches = {"flash": fa.flash_attention.launches,
                "decode": da.decode_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    handles = res.pop("handles")
    counts = engine_launch_checks(eng, res.pop("prefill_widths"), launches,
                                  cfg.decoder.layers)
    summary = {k: v for k, v in res.items() if k != "ttft_s"}
    log("engine", requests=len(handles), text_lengths=lengths,
        budgets=budgets, multimodal=4, prefix_len=ENGINE_PREFIX,
        prefix_hits=eng.prefix_hits, cancelled=cancelled, **summary,
        ttft_s=[res["ttft_s"].get(h.id) for h in handles],
        phase_s=dict(eng.phase_s), peak_mem_bytes=peak, card_bytes=total,
        **counts)
    for i, h in enumerate(handles):
        want = h.max_new_tokens
        ok = h.done and all(0 <= t < vocab for t in h.tokens) and (
            len(h.tokens) == want if h.id != cancelled.get("id")
            else cancel_at <= len(h.tokens) < want)
        check(ok, f"engine request {i}: done {h.done}, {len(h.tokens)} of "
                  f"{want} ids")
    check(bool(cancelled), "a request was cancelled")
    check(eng.prefix_hits == 1, f"prefix hits {eng.prefix_hits}")
    check(launches == counts["want"],
          f"engine launches {launches}, want {counts['want']}")
    check(peak < total, f"peak memory {peak} of {total}")
    return dict(summary, peak_mem_bytes=peak, decode_launches=launches["decode"],
                phase_s=dict(eng.phase_s))


def exact_tokens(name, got, want, ref_logits) -> list:
    """Greedy streams equal, or at the first divergence an fp32 near-tie of
    the reference: the top-2 gap of ``ref_logits(r, j)`` (the reference's
    logits for request r's j-th token) below ``NEAR_TIE``."""
    ties = []
    for r, (a, b) in enumerate(zip(got, want)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            check(len(a) == len(b), f"{name} request {r}: lengths "
                                    f"{len(a)} vs {len(b)}")
            continue
        top = torch.topk(ref_logits(r, j).float(), 2).values
        gap = (top[0] - top[1]).item()
        ties.append(dict(request=r, position=j, top2_gap=gap))
        check(gap < NEAR_TIE, f"{name} request {r} diverges at {j}, top-2 "
                              f"gap {gap} (not a near-tie)")
    return ties


def exact_model(dev, kx):
    """Phase 6j's model: a full-width fp32 Kosmos cut to 2 decoder and 2 ViT
    layers (phase 6b's cut), the decode kernel on."""
    from kosmosx_torch.models.kosmos import Kosmos

    c = kx.core.config
    cfg = c.KosmosConfig(
        decoder=c.MagnetoConfig(layers=2, dropout=0.0, attention_dropout=0.0,
                                decode_attn_kernel=True),
        vision=c.VisionConfig(layers=2))
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    return Kosmos(cfg, generator=g, device=dev), cfg


EXACT_NEW = 16


def phase_engine_exact(dev, kx, da) -> dict:
    """Phase 6j: exactness on the card, fp32 (TF32 off): 8 text requests
    (40-250 tokens, admission prefills of 256 positions through the flash
    kernel) on a text engine and 2 multimodal ones on a Kosmos engine,
    beside ``generate_text``/``generate_multimodal`` on the same model;
    then the text requests with ``spec_gamma=4`` and phase 6g's 2-layer
    draft, a shared-prefix run (plain attention serves it: no decode-kernel
    launch) and a 2-adapter multi-LoRA run. Greedy tokens identical except
    at fp32 near-ties; one decode step's logits over a staggered pool,
    kernel against plain attention, within 1e-4 of their largest value."""
    from kosmosx_torch.generate import sampler
    from kosmosx_torch.generate.sampler import _decode_logits
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.nn import decoder as dec
    from kosmosx_torch.serve import ServeConfig, ServeEngine
    from kosmosx_torch.train import lora

    model, cfg = exact_model(dev, kx)
    dcfg = cfg.decoder
    params = model["decoder"]
    vocab = dcfg.vocab_size
    g = torch.Generator().manual_seed(SEED + 22)
    lengths = torch.randint(40, 251, (8,), generator=g).tolist()
    prompts = [torch.randint(4, vocab, (n,), generator=g).tolist()
               for n in lengths]
    scfg = ServeConfig(max_batch=8, max_prompt_len=256, max_len=512,
                       sync_lag=2)
    greedy = sampler.SamplingConfig(max_new_tokens=EXACT_NEW, greedy=True)

    def text_logits(p, prompts_, want):
        def at(r, j):
            toks = torch.tensor([prompts_[r] + want[r][:j]], device=dev)
            with torch.inference_mode():
                return dec.decoder_forward(p, toks, dcfg)[0, -1]
        return at

    def reference(p, prompts_):
        with torch.inference_mode():
            return [sampler.generate_text(
                p, dcfg, torch.tensor([q], device=dev), greedy)[0].tolist()
                for q in prompts_]

    def serve(eng, prompts_, adapters=None, step_check=None):
        work = [dict(prompt=q, max_new_tokens=EXACT_NEW, at=i // 2,
                     adapter=None if adapters is None else adapters[i])
                for i, q in enumerate(prompts_)]
        res = drive_engine(eng, work, step_check)
        return [h.tokens for h in res.pop("handles")], res

    out = {}
    checked = []

    def step_check(eng, handles, step):
        """Once, with the pool staggered: kernel vs plain logits."""
        active = [s is not None for s in eng.slots]
        if checked or step < 3 or not any(active) or all(active):
            return
        act = torch.tensor(active, device=dev)
        tok = torch.where(act, eng.last, eng.scfg.pad_id)[:, None]
        n0 = da.decode_attention.launches
        with torch.inference_mode():
            kern = _decode_logits(params, dcfg, tok, cache_copy(eng.caches),
                                  eng.index)[act]
            da.decode_attention.launches = n0   # not the engine's launches
            plain = _decode_logits(
                params, dataclasses.replace(dcfg, decode_attn_kernel=False),
                tok, cache_copy(eng.caches), eng.index)[act]
        checked.append(dict(active=active, index=eng.index.tolist(),
                            rel_err=rel_err(kern, plain)))

    want = reference(params, prompts)
    eng = ServeEngine(params, dcfg, scfg, device=dev)
    da.decode_attention.launches = 0
    got, res = serve(eng, prompts, step_check=step_check)
    out["text"] = dict(launches=da.decode_attention.launches,
                       ties=exact_tokens("6j text", got, want,
                                         text_logits(params, prompts, want)),
                       tok_per_s=res["tok_per_s"], engine_tokens=got)
    check(bool(checked) and checked[0]["rel_err"] <= 1e-4,
          f"engine step kernel vs plain: {checked}")
    check(out["text"]["launches"] == dcfg.layers * eng.steps,
          f"6j decode launches {out['text']['launches']}")

    # multimodal, on a Kosmos engine, beside generate_multimodal
    mm_tokens, mm_lengths, mm_images = generation_requests(dev, cfg)
    mm_prompts = [mm_tokens[i, :int(mm_lengths[i])].tolist() for i in (0, 1)]
    meng = ServeEngine(model, dcfg, ServeConfig(max_batch=2,
                                                max_prompt_len=256,
                                                max_len=512),
                       kosmos_cfg=cfg, device=dev)
    res = drive_engine(meng, [dict(prompt=q, images=mm_images[i:i + 1],
                                   max_new_tokens=EXACT_NEW, at=0)
                              for i, q in enumerate(mm_prompts)])
    mm_got = [h.tokens for h in res["handles"]]
    with torch.inference_mode():
        mm_want = [sampler.generate_multimodal(
            model, cfg, torch.tensor([q], device=dev), mm_images[i:i + 1],
            greedy)[0].tolist() for i, q in enumerate(mm_prompts)]

    def mm_logits(r, j):
        toks = torch.tensor([mm_prompts[r] + mm_want[r][:j]], device=dev)
        with torch.inference_mode():
            return model.apply(toks, mm_images[r:r + 1])[0, -1]

    out["multimodal"] = dict(ties=exact_tokens("6j multimodal", mm_got,
                                               mm_want, mm_logits))

    # speculative serving with phase 6g's 2-layer draft
    draft_cfg = dataclasses.replace(dcfg, layers=2)
    draft = KosmosLanguage(draft_cfg, generator=torch.Generator(
        device=dev).manual_seed(SEED + 18), device=dev)
    seng = ServeEngine(params, dcfg, dataclasses.replace(scfg, spec_gamma=4),
                       draft_params=draft, draft_cfg=draft_cfg, device=dev)
    da.decode_attention.launches = 0
    got, res = serve(seng, prompts)
    out["spec"] = dict(ties=exact_tokens("6j spec", got, want,
                                         text_logits(params, prompts, want)),
                       accepted=seng.accepted_total,
                       emitted=seng.emitted_total,
                       draft_decode_launches=da.decode_attention.launches)
    check(out["spec"]["draft_decode_launches"] > 0,
          "the spec draft's steps launch the decode kernel")

    # a shared prefix of 64 tokens: plain attention serves every decode
    prefix = torch.randint(4, vocab, (64,), generator=g).tolist()
    sh_prompts = [prefix + q[:100] for q in prompts[:4]]
    sh_want = reference(params, sh_prompts)
    sheng = ServeEngine(params, dcfg, scfg, device=dev)
    sheng.register_prefix(prefix, share=True)
    da.decode_attention.launches = 0
    got, _ = serve(sheng, sh_prompts)
    out["share"] = dict(ties=exact_tokens(
        "6j share", got, sh_want, text_logits(params, sh_prompts, sh_want)),
        prefix_hits=sheng.prefix_hits,
        decode_launches=da.decode_attention.launches)
    check(out["share"]["decode_launches"] == 0 and sheng.prefix_hits == 4,
          f"shared-prefix run: {out['share']}")

    # two adapters (rank 8, random b) beside base requests
    trees = {}
    for name, seed in (("A", 31), ("B", 32)):
        gl = torch.Generator(device=dev).manual_seed(SEED + seed)
        tree = lora.strip_lora(lora.add_lora(gl, params, 8))[1]

        def rand_b(node):
            if isinstance(node, dict):
                if "b" in node and "a" in node:
                    node["b"] = torch.randn(node["b"].shape, generator=gl,
                                            device=dev) * 0.05
                for v in node.values():
                    rand_b(v)
            elif isinstance(node, list):
                for v in node:
                    rand_b(v)
        rand_b(tree)
        trees[name] = tree
    names = ["A", "B", None, "A"]
    lo_prompts = prompts[:4]
    lo_want = [reference(params if n is None else
                         lora.attach_lora(params, trees[n]), [q])[0]
               for q, n in zip(lo_prompts, names)]
    leng = ServeEngine(params, dcfg, scfg, device=dev)
    for name, tree in trees.items():
        leng.load_adapter(name, tree)
    got, _ = serve(leng, lo_prompts, adapters=names)

    def lo_logits(r, j):
        p = params if names[r] is None else lora.attach_lora(params,
                                                             trees[names[r]])
        return text_logits(p, lo_prompts, lo_want)(r, j)

    out["lora"] = dict(ties=exact_tokens("6j lora", got, lo_want, lo_logits),
                       changed_by_adapter=sum(
                           a != b for a, b in zip(lo_want, want[:4])))
    log("engine_exact", dtype="float32", layers=dcfg.layers,
        text_lengths=lengths, new_tokens=EXACT_NEW, near_tie_bar=NEAR_TIE,
        step_kernel_vs_plain=checked[0],
        **{k: {kk: vv for kk, vv in v.items() if kk != "engine_tokens"}
           for k, v in out.items()})
    return dict(model=model, cfg=cfg, engine=eng, prompts=prompts,
                tokens=out["text"]["engine_tokens"], want=want,
                decode_launches=out["text"]["launches"],
                text_logits=text_logits(params, prompts, want))


def http_json(url, payload=None, timeout=300):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def phase_http_cli(dev, exact) -> None:
    """Phase 6l: ``ServeServer`` on 127.0.0.1, port 0, over 6j's fp32 text
    engine (warmup on start): ``GET /healthz``, ``GET /v1/stats`` and 4
    concurrent ``POST /v1/completions`` (2 streaming) of 6j's prompts, whose
    tokens must be 6j's engine tokens (near-ties as in 6j); then the
    serving CLI in this process at full width with two ``--prompt``s and
    ``--max-new-tokens 8``, plain and ``--w8``: both exit 0."""
    import io
    import threading

    from kosmosx_torch.scripts import serve as cli
    from kosmosx_torch.serve import ServeServer

    srv = ServeServer(exact["engine"], port=0).start()
    base = f"http://{srv.address[0]}:{srv.address[1]}"
    results = [None] * 4
    try:
        health = http_json(base + "/healthz")

        def post(i):
            stream = i % 2 == 1
            _, body = http_json(base + "/v1/completions", {
                "prompt": exact["prompts"][i], "max_tokens": EXACT_NEW,
                "stream": stream})
            if stream:
                lines = [json.loads(x) for x in body.splitlines() if x]
                results[i] = lines[-1]["tokens"]
            else:
                results[i] = json.loads(body)["tokens"]

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        stats = json.loads(http_json(base + "/v1/stats")[1])
    finally:
        srv.stop()
    ties = exact_tokens("6l http", results, exact["tokens"][:4],
                        exact["text_logits"])
    cli_runs = {}
    for name, extra in (("plain", []), ("w8", ["--w8"])):
        argv = ["--prompt", "A photo of a cat sitting on a mat.",
                "--prompt", "The quick brown fox", "--max-new-tokens", "8",
                "--seed", str(SEED)] + extra
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        cli_runs[name] = dict(argv=argv, rc=rc,
                              seconds=time.perf_counter() - t0,
                              lines=out.getvalue().splitlines(),
                              rate=err.getvalue().strip().splitlines()[-1:])
        gc.collect()
        torch.cuda.empty_cache()
    log("http_cli", healthz=health, stats=stats, ties=ties,
        answered=[len(r or []) for r in results], cli=cli_runs)
    check(health[0] == 200 and stats["emitted_total"] > 0,
          f"healthz {health}, stats {stats}")
    check(all(r is not None for r in results), "4 HTTP answers")
    for name, r in cli_runs.items():
        check(r["rc"] == 0 and len(r["lines"]) == 2, f"serving CLI {name}: {r}")


def w8_engine_work(vocab: int) -> list:
    """6k's requests: 8 text prompts of 6i's lengths (the seed's draws),
    48 new tokens each, all submitted at once."""
    g = torch.Generator().manual_seed(SEED + 20)
    lo, hi = ENGINE_TEXT_LENGTHS
    lengths = torch.randint(lo, hi + 1, (8,), generator=g).tolist()
    return [dict(prompt=torch.randint(4, vocab, (n,), generator=g).tolist(),
                 max_new_tokens=48, at=0) for n in lengths]


def phase_w8_engine(dev, qm, da, w8, cfg, bf16_engine) -> dict:
    """Phase 6k: phase 6c's W8 model under the engine (decode kernel on,
    phase 6i's ServeConfig) with 8 text requests of 6i's lengths and 48 new
    tokens: both W8 wrappers' Hopper kernels launched, every vocab-head
    call on the Hopper kernel, ids in the vocabulary; tok/s and peak memory
    beside 6i's."""
    from kosmosx_torch.serve import ServeConfig, ServeEngine

    ecfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, decode_attn_kernel=True))
    vocab = cfg.decoder.vocab_size
    work = w8_engine_work(vocab)
    lengths = [len(w["prompt"]) for w in work]
    eng = ServeEngine(w8, ecfg.decoder,
                      ServeConfig(max_batch=8, max_prompt_len=512,
                                  max_len=1024, sync_lag=4),
                      kosmos_cfg=ecfg, device=dev)
    for fn in (qm.w8_matmul, qm.w8_matmul_stacked, da.decode_attention):
        fn.launches = 0
        if hasattr(fn, "hopper_launches"):
            fn.hopper_launches = 0
    torch.cuda.reset_peak_memory_stats()
    with vocab_head_paths(qm, cfg) as vocab_paths:
        res = drive_engine(eng, work)
    peak = torch.cuda.max_memory_allocated()
    handles = res.pop("handles")
    launches = {"w8_matmul.hopper": qm.w8_matmul.hopper_launches,
                "w8_matmul_stacked.hopper": qm.w8_matmul_stacked.hopper_launches,
                "w8_matmul_stacked": qm.w8_matmul_stacked.launches,
                "decode": da.decode_attention.launches}
    keys = ("tok_per_s", "ttft_p50_s", "inter_token_p50_s",
            "inter_token_p99_s", "peak_mem_bytes")
    log("w8_engine", requests=8, text_lengths=lengths, new_tokens=48,
        **{k: v for k, v in res.items() if k != "ttft_s"},
        peak_mem_bytes=peak, launches=launches,
        vocab_head_paths=dict(vocab_paths), phase_s=dict(eng.phase_s),
        bf16_engine={k: bf16_engine[k] for k in keys})
    check(all(h.done and len(h.tokens) == 48
              and all(0 <= t < vocab for t in h.tokens) for h in handles),
          "W8 engine: every request done with 48 ids in the vocabulary")
    check(launches["w8_matmul.hopper"] > 0
          and launches["w8_matmul_stacked.hopper"] > 0,
          f"W8 engine Hopper launches {launches}")
    check(set(vocab_paths) == {"hopper"},
          f"W8 engine vocab head paths {dict(vocab_paths)}")
    check(launches["decode"] == cfg.decoder.layers * eng.steps,
          f"W8 engine decode launches {launches}")
    return launches


# -- phases 10a-10f: LoRA and QLoRA training, DPO, distillation ---------------

W8_GRAD_SHAPES = ((4, 2048, 8192), (3968, 2048, 8192), (4, *W8_VOCAB),
                  (3968, *W8_VOCAB))
LORA_RANK = 16
LORA_STEPS = 8
LORA_LR = 1e-3
W8_COUNTERS = ("w8_matmul", "w8_matmul_stacked")


def w8_counts(qm) -> dict:
    """Both W8 wrappers' launches and, among them, the Hopper kernel's."""
    out = {}
    for name in W8_COUNTERS:
        fn = getattr(qm, name)
        out[name] = fn.launches
        out[name + ".hopper"] = fn.hopper_launches
    return out


def _w8_grad_case(dev, g, run, plain, x, bar, **shape) -> dict:
    """``dx`` of one W8 wrapper call under autograd (the kernel forward,
    the operator's backward) against ``torch.autograd.grad`` of
    ``w8_matmul_plain`` on the same x and dy: the output has a grad_fn, two
    backward runs are bit-identical, errors relative to the reference's
    largest value."""
    xs = [x.detach().clone().requires_grad_() for _ in range(3)]
    ys = [run(xs[0]), run(xs[1]), plain(xs[2])]
    dy = torch.randn(ys[0].shape, generator=g, device=dev).to(x.dtype)
    dxs = [torch.autograd.grad(y, xx, dy)[0] for y, xx in zip(ys, xs)]
    torch.cuda.synchronize()
    out = dict(grad_fn=ys[0].grad_fn is not None,
               y_rel_err=rel_err(ys[0], ys[2]),
               dx_max_abs_err=max_err(dxs[0], dxs[2]),
               dx_rel_err=rel_err(dxs[0], dxs[2]),
               bit_identical=torch.equal(dxs[0], dxs[1]))
    log("w8_grad", **shape, rel_bar=bar, **out)
    check(out["grad_fn"], f"W8 {shape}: the kernel's output has no grad_fn")
    check(out["y_rel_err"] < bar and out["dx_rel_err"] < bar,
          f"W8 {shape}: forward or dx against the plain version: {out}")
    check(out["bit_identical"], f"W8 {shape}: two backward runs differ")
    return out


def phase_w8_grad(dev, qm) -> dict:
    """Phase 10a: dx through ``w8_matmul`` (M 4 and 3968 over (2048, 8192)
    and over the vocab head's codes at their padded pitch) and
    ``w8_matmul_stacked`` (layer 11 of a (24, 2048, 8192) stack), bf16
    (bar 1e-2) and fp32 (bar 1e-5, TF32 off), each wrapper's kernel
    launched for every forward."""
    from kosmosx_torch.utils.quantize import _quantize_w

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    results, before = [], w8_counts(qm)
    for m, k, n in W8_GRAD_SHAPES:
        w = _quantize_w(torch.randn(k, n, generator=g, device=dev) * 0.02)
        x = torch.randn(m, k, generator=g, device=dev)
        for dtype, bar in W8_BARS:
            results.append(_w8_grad_case(
                dev, g, lambda xx: qm.w8_matmul(xx, w["q"], w["scale"]),
                lambda xx: qm.w8_matmul_plain(xx, w["q"], w["scale"]),
                x.to(dtype), bar, wrapper="w8_matmul", m=m, k=k, n=n,
                pitch=w["q"].stride(0), dtype=str(dtype).split(".")[-1]))
        del w
    w = _quantize_w(torch.randn(W8_STACK, generator=g, device=dev) * 0.02)
    layer = torch.tensor(11, dtype=torch.int32, device=dev)
    for m in (4, 3968):
        x = torch.randn(m, W8_STACK[1], generator=g, device=dev)
        for dtype, bar in W8_BARS:
            results.append(_w8_grad_case(
                dev, g,
                lambda xx: qm.w8_matmul_stacked(xx, w["q"], w["scale"], layer),
                lambda xx: qm.w8_matmul_plain(xx, w["q"][11], w["scale"][11]),
                x.to(dtype), bar, wrapper="w8_matmul_stacked", m=m,
                stack=list(W8_STACK), layer=11,
                dtype=str(dtype).split(".")[-1]))
    launches = {k: v - before[k] for k, v in w8_counts(qm).items()}
    log("w8_grad_launches", **launches)
    check(launches["w8_matmul"] == 2 * len(W8_GRAD_SHAPES) * len(W8_BARS)
          and launches["w8_matmul_stacked"] == 2 * 2 * len(W8_BARS),
          f"W8 kernel launches under autograd: {launches}")
    return {"cases": len(results),
            "worst_dx_rel_err": max(r["dx_rel_err"] for r in results)}


class GradRecorder:
    """An optimizer stand-in for ``make_lora_train_step`` that keeps the
    gradients it is given, then hands them to ``inner`` (or only returns
    their global norm)."""

    def __init__(self, inner=None):
        self.inner, self.grads = inner, None

    def step(self, grads):
        from kosmosx_torch.train.optim import global_norm

        self.grads = {n: None if t is None else t.detach().clone()
                      for n, t in grads.items()}
        return global_norm(grads) if self.inner is None \
            else self.inner.step(grads)


def lora_grads(base, kcfg, lora_tree, batch, *, optimizer=None) -> tuple:
    """(loss, factor gradients) of one ``make_lora_train_step`` of
    ``base`` run under ``kcfg`` with ``lora_tree``'s factors (a state of
    its own over the same storage) on ``batch``: the step's optimizer
    records the gradients and then runs ``optimizer`` on them, if given."""
    from kosmosx_torch.train.lora import lora_state, make_lora_train_step
    from kosmosx_torch.train.trainer import kosmos_loss_fn

    base.config = kcfg
    state = lora_state(lora_tree, lambda p: GradRecorder(
        None if optimizer is None else optimizer(p)), None)
    step = make_lora_train_step(kosmos_loss_fn(kcfg), state["opt_state"])
    _, metrics = step(state, base, batch)
    return metrics["loss"].item(), state["opt_state"].grads


def phase_lora_reference(dev, kx, fa, qm) -> dict:
    """Phase 10b: phase 8's depth-cut fp32 Kosmos (2 decoder and 2 ViT
    layers) quantized W8 in the stacked layout, LoRA rank 8 on the default
    targets (``b`` drawn small, so every factor takes a gradient): one
    ``make_lora_train_step``'s loss and factor gradients through the W8
    and flash kernels (remat "dots") against ``set_w8_kernel("off")`` and
    plain attention, bar 1e-3 of each gradient's largest value (for a 0-d
    ``scale``, whose gradient ``<b, dL/db> / scale`` is one sum that may
    cancel, of the sum of its terms' magnitudes); after an AdamW step the codes, scales and every other base tensor
    bit-identical. Then the same on the unquantized base in bf16
    (computing in fp32)."""
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.nn import layers
    from kosmosx_torch.train.lora import add_lora, lora_state_dict, strip_lora
    from kosmosx_torch.train.optim import make_optimizer

    c = kx.core.config
    cfg = c.KosmosConfig(
        decoder=c.MagnetoConfig(layers=2, dropout=0.0, attention_dropout=0.0,
                                remat=True, remat_policy="dots"),
        vision=c.VisionConfig(layers=2))
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    dense = Kosmos(cfg, generator=g, device=dev)
    tokens = torch.randint(4, cfg.decoder.vocab_size, (2, 448), generator=g,
                           device=dev)
    tokens[:, 0] = 0
    tokens[1, 400:] = cfg.decoder.padding_idx
    batch = {"text_tokens": tokens,
             "images": pixels(2, g, dev, cfg.vision.image_size)}
    counters = flash_counters(fa)
    results = {}

    def check_base(name, base, kcfg):
        lora = strip_lora(add_lora(g, base, 8))[1]
        with torch.no_grad():
            for n, t in lora_state_dict(lora).items():
                if n.endswith(".b"):
                    t.normal_(0.0, 0.02, generator=g)
        plain = dataclasses.replace(kcfg, decoder=dataclasses.replace(
            kcfg.decoder, use_flash_attention=False, remat=False))
        layers.set_w8_kernel("off")
        try:
            ref_loss, ref = lora_grads(base, plain, lora, batch)
        finally:
            layers.set_w8_kernel("auto")
        saved = {n: p.detach().clone() for n, p in base.named_parameters()}
        flash0 = {n: fn.launches for n, fn in counters.items()}
        w80 = w8_counts(qm)
        loss, grads = lora_grads(base, kcfg, lora, batch, optimizer=lambda p:
                                 make_optimizer("adamw", lambda n: 1e-3, p))
        launches = {n: fn.launches - flash0[n] for n, fn in counters.items()}
        launches.update({k: v - w80[k] for k, v in w8_counts(qm).items()})
        worst, worst_name = 0.0, None
        factors = lora_state_dict(lora)
        for n, r in ref.items():
            if r is None:  # a B expert's: no position reaches it
                check(grads[n] is None, f"{name} {n}: a gradient only on "
                                        f"the kernel path")
                continue
            err = rel_err(grads[n], r)
            if n.endswith(".scale"):
                # dL/dscale = <b, dL/db> / scale, one sum that may cancel:
                # its error against the sum of its terms' magnitudes
                b, gb = factors[n[:-5] + "b"], ref[n[:-5] + "b"]
                terms = ((b * gb).abs().sum() / factors[n].abs()).item()
                err = max_err(grads[n], r) / max(terms, r.abs().item(), 1e-30)
            if err > worst:
                worst, worst_name = err, n
        same = all(torch.equal(p, saved[n]) for n, p in base.named_parameters())
        results[name] = dict(loss=loss, ref_loss=ref_loss, factors=len(ref),
                             with_grad=sum(r is not None
                                           for r in ref.values()),
                             max_rel_grad_err=worst, worst_factor=worst_name,
                             base_bit_identical=same, launches=launches)
        log("lora_reference", base=name, layers=2, positions=512, rank=8,
            bar=1e-3, **results[name])
        check(abs(loss - ref_loss) < 1e-3 * max(1.0, abs(ref_loss)),
              f"{name}: kernel vs plain loss {loss} vs {ref_loss}")
        check(worst < 1e-3, f"{name}: factor gradient {worst_name}: {worst}")
        check(same, f"{name}: a base tensor changed in the LoRA step")
        check(launches["flash_fwd"] == 4 and launches["flash_bwd_dq"] == 2,
              f"{name}: flash launches {launches}")
        return launches

    w8, w8_cfg = w8_model(dense, cfg)
    launches = check_base("w8_stacked", w8, w8_cfg)
    check(launches["w8_matmul"] > 0 and launches["w8_matmul_stacked"] > 0,
          f"W8 launches in the QLoRA step {launches}")
    del w8
    check_base("bf16", dense.to(torch.bfloat16), cfg)
    return results


def lora_train_run(dev, fa, qm, name, base, cfg, reading=None) -> dict:
    """``LoraTrainer.run`` at rank 16 on the default targets, AdamW (lr
    1e-3 after a one-step warmup), ``LORA_STEPS`` steps on phase 9's
    repeated batch: finite losses, step 8's below step 2's, every base
    tensor bit-identical (held on the host), optimizer state 2 x the
    factors' bytes, the backward kernels once per layer and step and the
    forward twice (remat); step time, tokens/s and peak memory beside
    ``reading`` (phase 9's, or 10c's)."""
    from kosmosx_torch.train.lora import LoraTrainer, lora_state_dict
    from kosmosx_torch.train.trainer import TrainConfig, kosmos_loss_fn

    tcfg = TrainConfig(batch_size=2, seq_len=TRAIN_TEXT,
                       learning_rate=LORA_LR, optimizer="adamw",
                       schedule="constant", warmup_steps=1,
                       total_steps=LORA_STEPS, checkpoint_every=0,
                       log_every=1, freeze=("clip",), seed=SEED + 23)
    trainer = LoraTrainer(None, kosmos_loss_fn(cfg), tcfg, rank=LORA_RANK,
                          base_params=base, device=dev)
    state = trainer.init_state()
    saved = {n: p.detach().cpu() for n, p in base.named_parameters()}
    factors = lora_state_dict(state["lora"])
    factor_bytes = sum(t.numel() * t.element_size() for t in factors.values())
    batch = train_batch(cfg)
    logs, stamps = [], []

    def log_fn(step, m):
        stamps.append(time.perf_counter())
        logs.append(m)

    counters = flash_counters(fa)
    flash0 = {n: fn.launches for n, fn in counters.items()}
    w80 = w8_counts(qm)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with vocab_head_paths(qm, cfg) as vocab:
        trainer.run(itertools.repeat(batch, LORA_STEPS), log_fn=log_fn)
    peak = torch.cuda.max_memory_allocated()
    launches = {n: fn.launches - flash0[n] for n, fn in counters.items()}
    launches.update({k: v - w80[k] for k, v in w8_counts(qm).items()})
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    mean_s = sum(step_s[2:]) / len(step_s[2:])
    tokens = 2 * (TRAIN_TEXT + cfg.image_embed_len)
    losses = [m["loss"] for m in logs]
    same = all(torch.equal(p.detach().cpu(), saved[n])
               for n, p in base.named_parameters())
    moment_bytes = trainer.optimizer.moment_bytes()
    out = dict(steps=LORA_STEPS, rank=LORA_RANK, lr=LORA_LR,
               batch=[2, TRAIN_TEXT + cfg.image_embed_len],
               base_params=sum(p.numel() for p in base.parameters()),
               factors=sum(t.numel() for t in factors.values()),
               factor_bytes=factor_bytes, moment_bytes=moment_bytes,
               losses=losses, grad_norms=[m["grad_norm"] for m in logs],
               step_s=step_s, step_s_mean_3_8=mean_s,
               tokens_per_s=tokens / mean_s, peak_mem_bytes=peak,
               base_bit_identical=same, launches=launches,
               vocab_head_paths=dict(vocab))
    log(name, **out, reference=reading)
    layers = cfg.decoder.layers
    check(len(logs) == LORA_STEPS and all(
        math.isfinite(x) for x in losses + out["grad_norms"]),
        f"{name}: finite losses and gradient norms {losses}")
    check(losses[-1] < losses[1], f"{name}: loss of step 8 {losses[-1]} "
                                  f"not below step 2 {losses[1]}")
    check(same, f"{name}: a base tensor changed")
    check(moment_bytes == 2 * factor_bytes,
          f"{name}: moments {moment_bytes} B, factors {factor_bytes} B")
    check(launches["flash_bwd_prep"] == launches["flash_bwd_dkv"]
          == launches["flash_bwd_dq"] == layers * LORA_STEPS
          and launches["flash_fwd"] == launches["flash_fwd_prep"]
          == 2 * layers * LORA_STEPS,
          f"{name}: flash launches {launches}")
    return out


def phase_lora_train(dev, kx, fa, qm, reading) -> dict:
    """Phase 10c: phase 9's recipe (the flagship Kosmos, fp32 parameters,
    bf16 compute, remat "dots", flash) as LoRA."""
    from kosmosx_torch.models.kosmos import Kosmos

    cfg = train_config(kx)
    base = Kosmos(cfg, generator=torch.Generator(device=dev).manual_seed(
        SEED + 8), device=dev)
    return lora_train_run(dev, fa, qm, "lora_train", base, cfg, reading)


def phase_qlora_train(dev, kx, fa, qm, reading) -> dict:
    """Phase 10d: phase 6c's W8 flagship (bf16 parameters quantized, the
    decoder stacked) as QLoRA under 10c's recipe: also both W8 wrappers on
    their Hopper kernels, every vocab-head call among them, and the codes
    and scales bit-identical."""
    from kosmosx_torch.models.kosmos import Kosmos

    cfg = train_config(kx)
    dense = Kosmos(cfg, generator=torch.Generator(device=dev).manual_seed(
        SEED + 2), device=dev).to(torch.bfloat16)
    base, cfg = w8_model(dense, cfg)
    del dense
    out = lora_train_run(dev, fa, qm, "qlora_train", base, cfg, reading)
    launches, vocab = out["launches"], out["vocab_head_paths"]
    for name in W8_COUNTERS:
        check(launches[name + ".hopper"] > 0,
              f"QLoRA: {name} never took its Hopper kernel: {launches}")
    check(set(vocab) == {"hopper"} and vocab["hopper"] > 0,
          f"QLoRA vocab-head calls {vocab}: the Hopper kernel only")
    return out


DPO_ROWS, DPO_LENGTH, DPO_BATCH, DPO_STEPS = 8, 512, 4, 4


def write_prefs(path: Path, rng, n: int) -> None:
    """``n`` JSONL preference rows made from the seed: prompts of 128-256
    characters, completions of 64-192 (tokens, to the byte tokenizer)."""
    def text(lo, hi):
        return seeded_text(rng, 60)[:int(rng.randint(lo, hi + 1))]

    path.write_text("\n".join(json.dumps(
        {"prompt": text(128, 256), "chosen": text(64, 192),
         "rejected": text(64, 192)}) for _ in range(n)) + "\n")


def phase_dpo(dev, kx, fa) -> dict:
    """Phase 10e: DPO with LoRA rank 16 on phase 9c's model (the flagship
    text decoder, bf16 parameters, remat "dots", flash; dropout 0, so the
    policy's first forward is the reference's), the frozen base as the
    reference: 8 rows read at length 512 through
    ``preference_jsonl_batches``, batch 4, 4 steps, beta 0.1. The first
    loss is ln 2 within 1e-3, the metrics finite, the flash forward
    launched in ``compute_ref_logprobs``."""
    import tempfile

    import numpy as np

    from kosmosx_torch.data.tokenizer import KosmosTokenizer
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.train.data import preference_jsonl_batches
    from kosmosx_torch.train.dpo import compute_ref_logprobs, dpo_loss_fn
    from kosmosx_torch.train.lora import LoraTrainer
    from kosmosx_torch.train.trainer import TrainConfig

    c = kx.core.config
    cfg = c.MagnetoConfig(compute_dtype="bfloat16", scan_layers=True,
                          remat=True, remat_policy="dots", dropout=0.0,
                          attention_dropout=0.0, use_flash_attention=True,
                          max_positions=8194)
    base = KosmosLanguage(cfg, generator=torch.Generator(device=dev)
                          .manual_seed(SEED + 15), device=dev).to(
                              torch.bfloat16)
    tcfg = TrainConfig(batch_size=DPO_BATCH, seq_len=DPO_LENGTH,
                       learning_rate=LORA_LR, optimizer="adamw",
                       schedule="constant", warmup_steps=1,
                       total_steps=DPO_STEPS, checkpoint_every=0, log_every=1,
                       prefetch=False, seed=SEED + 24)
    trainer = LoraTrainer(None, dpo_loss_fn(cfg, beta=0.1), tcfg,
                          rank=LORA_RANK, base_params=base, device=dev)
    trainer.init_state()
    ref_launches, logs, stamps = [], [], []

    def with_ref(batches):
        for b in batches:
            n0 = fa.flash_attention.launches
            out = compute_ref_logprobs(trainer.base_params, cfg, b)
            ref_launches.append(fa.flash_attention.launches - n0)
            yield out

    def log_fn(step, m):
        stamps.append(time.perf_counter())
        logs.append(m)

    counters = flash_counters(fa)
    flash0 = {n: fn.launches for n, fn in counters.items()}
    with tempfile.TemporaryDirectory() as tmp:
        prefs = Path(tmp) / "prefs.jsonl"
        write_prefs(prefs, np.random.RandomState(SEED + 24), DPO_ROWS)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.run(with_ref(preference_jsonl_batches(
            str(prefs), KosmosTokenizer(), batch_size=DPO_BATCH,
            length=DPO_LENGTH, epochs=None)), steps=DPO_STEPS, log_fn=log_fn)
    peak = torch.cuda.max_memory_allocated()
    launches = {n: fn.launches - flash0[n] for n, fn in counters.items()}
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    metrics = ("loss", "reward_margin", "reward_accuracy", "chosen_logp",
               "rejected_logp", "grad_norm")
    out = dict(rows=DPO_ROWS, length=DPO_LENGTH, batch=DPO_BATCH,
               steps=DPO_STEPS, beta=0.1, rank=LORA_RANK,
               **{k: [m[k] for m in logs] for k in metrics},
               first_loss_minus_ln2=logs[0]["loss"] - math.log(2.0),
               ref_flash_launches=ref_launches, launches=launches,
               step_s=step_s, peak_mem_bytes=peak)
    log("dpo", **out)
    check(len(logs) == DPO_STEPS and all(math.isfinite(m[k]) for m in logs
                                          for k in metrics),
          f"DPO metrics finite: {logs}")
    check(abs(out["first_loss_minus_ln2"]) < 1e-3,
          f"DPO first loss {logs[0]['loss']} is not ln 2")
    check(ref_launches and all(n == 2 * cfg.layers for n in ref_launches),
          f"flash forward launches per compute_ref_logprobs {ref_launches}")
    return out


DISTILL_STEPS, DISTILL_BATCH, DISTILL_LEN, DISTILL_LR = 100, 8, 256, 1e-3
# the distillation stream's token ids lie below this, so that 100 steps see
# each id often enough for the draft to learn the teacher's argmax on it
DISTILL_VOCAB = 32


def spec_setup(dev, dcfg):
    """Phase 6g's speculative run: a 2-layer bf16 draft of the flagship
    width from a seed, and 4 text prompts of ``SPEC_LENGTHS`` tokens."""
    from kosmosx_torch.models.language import KosmosLanguage

    draft_cfg = dataclasses.replace(dcfg, layers=2)
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    draft = KosmosLanguage(draft_cfg, generator=g, device=dev).to(
        torch.bfloat16)
    lengths = torch.tensor(SPEC_LENGTHS, device=dev)
    prompt = torch.randint(4, dcfg.vocab_size, (4, max(SPEC_LENGTHS)),
                           generator=g, device=dev)
    prompt[torch.arange(prompt.shape[1], device=dev)[None]
           >= lengths[:, None]] = dcfg.padding_idx
    return draft, draft_cfg, prompt, lengths


def phase_distill(dev, model, cfg, spec6g) -> dict:
    """Phase 10f: ``distill_draft`` of a 2-layer draft at the flagship
    width from phase 6g's decoder (the teacher, bf16), 100 steps of 8 x 256
    synthetic tokens (ids below ``DISTILL_VOCAB``) at lr 1e-3: the loss
    falls and the agreement rises from the fresh draft's on the first
    batch. Then greedy ``speculative_generate`` (gamma 4, 48 new tokens)
    with the distilled draft on 6g's prompts, its acceptance beside 6g's
    random draft's, and on 4 prompts of 128 tokens from the distillation
    stream beside 6g's random draft on them; and on an fp32 copy of the
    teacher, whose tokens are ``generate_text``'s (a divergence passes
    only at an fp32 near-tie, phase 6j's rule: in bf16 a chunked verify
    and one-token steps part at near-ties, 6g's agreement is reported).
    No acceptance is held: the teacher is a random init."""
    from kosmosx_torch.generate import sampler
    from kosmosx_torch.generate.speculative import speculative_generate
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.nn import decoder as dec
    from kosmosx_torch.train.data import synthetic_text_batches
    from kosmosx_torch.train.distill import distill_draft, distill_loss

    dcfg = dataclasses.replace(cfg.decoder, decode_attn_kernel=True)
    teacher = model["decoder"]
    random_draft, draft_cfg, prompt, lengths = spec_setup(dev, dcfg)

    def batches(seed=SEED + 25):
        return synthetic_text_batches(
            batch_size=DISTILL_BATCH, seq_len=DISTILL_LEN,
            vocab_size=DISTILL_VOCAB, seed=seed)

    first = torch.as_tensor(next(batches())["input_ids"], device=dev).long()
    fresh = KosmosLanguage(draft_cfg, generator=torch.Generator(
        device=dev).manual_seed(SEED + 26), device=dev)
    with torch.no_grad():
        _, m0 = distill_loss(dec.decoder_forward(fresh, first, draft_cfg),
                             dec.decoder_forward(teacher, first, dcfg))
    m0 = {k: float(v) for k, v in m0.items()}
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    draft, m1 = distill_draft(teacher, dcfg, draft_cfg, batches(),
                              steps=DISTILL_STEPS, learning_rate=DISTILL_LR,
                              seed=SEED + 26)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    scfg = sampler.SamplingConfig(max_new_tokens=48, greedy=True)

    def spec(target, cfg_t, drafter, cfg_d, p, lens):
        out, stats = speculative_generate(target, drafter, cfg_t, cfg_d, p,
                                          scfg, gamma=4, prompt_lengths=lens)
        return out, dict(stats, acceptance_rate=stats["accepted"]
                         / max(stats["proposed"], 1))

    out, stats = spec(teacher, dcfg, draft, draft_cfg, prompt, lengths)
    plain = sampler.generate_text(teacher, dcfg, prompt, scfg,
                                  prompt_lengths=lengths)
    stream = torch.as_tensor(next(batches(SEED + 27))["input_ids"][:4, :128],
                             device=dev).long()
    stream_lens = torch.full((4,), 128, device=dev)
    in_stream = {name: spec(teacher, dcfg, d, draft_cfg, stream,
                            stream_lens)[1]
                 for name, d in (("distilled", draft),
                                 ("6g_random", random_draft))}
    del random_draft

    f32 = dataclasses.replace(dcfg, compute_dtype="float32")
    teacher32 = copy.deepcopy(teacher).float()
    d32 = dataclasses.replace(dcfg, layers=2, compute_dtype="float32")
    out32, stats32 = spec(teacher32, f32, draft, d32, prompt, lengths)
    plain32 = sampler.generate_text(teacher32, f32, prompt, scfg,
                                    prompt_lengths=lengths)

    def ref_logits(r, j):
        seq = torch.cat([prompt[r, :int(lengths[r])], plain32[r, :j]])[None]
        with torch.no_grad():
            return dec.decoder_forward(teacher32, seq, f32)[0, -1]

    ties = exact_tokens("distilled speculative (fp32)", out32.tolist(),
                        plain32.tolist(), ref_logits)
    del teacher32
    result = dict(
        steps=DISTILL_STEPS, batch=[DISTILL_BATCH, DISTILL_LEN],
        token_ids_below=DISTILL_VOCAB, lr=DISTILL_LR, draft_layers=2,
        first=m0, last=m1, seconds=seconds, step_s=seconds / DISTILL_STEPS,
        peak_mem_bytes=peak,
        speculative=dict(stats, token_agreement_vs_generate_text=(
            out == plain).float().mean().item()),
        speculative_6g_random_draft=spec6g,
        speculative_stream_prompts=in_stream,
        fp32=dict(stats32, token_agreement_vs_generate_text=(
            out32 == plain32).float().mean().item(), near_ties=ties))
    log("distill", **result)
    check(m1["distill_loss"] < m0["distill_loss"],
          f"distill loss did not fall: {m0} -> {m1}")
    check(m1["teacher_agreement"] > m0["teacher_agreement"],
          f"teacher agreement did not rise: {m0} -> {m1}")
    check(tuple(out.shape) == (4, 48)
          and bool(((out >= 0) & (out < dcfg.vocab_size)).all()),
          "distilled speculative ids in the vocabulary")
    return result


# ---------------------------------------------------------------------------
# phases 11a-11g: the mixture-of-experts decoder and checkpoint I/O
# ---------------------------------------------------------------------------

MOE_SEQ, MOE_BATCH = 2048, 4       # 11b: moe_bench's forward shape
MOE_TRAIN_STEPS = 8
MOE_GEN_LENGTHS = (192, 256, 320, 448)
MOE_ENGINE_REQUESTS = 16
MOE_EXACT_LENGTHS = (37, 118, 205, 311, 480)   # 11d's fp32 exactness


def moe_config(kx, **kw):
    """moe_bench's MoE decoder (benchmarks/moe_bench.py:38-44,
    benchmarks/serve_bench.py:135-143): 24 layers, 2048 wide, 32 heads of
    64, vocab 32002, 8194 positions, 4 experts of ffn 8192, top-2, capacity
    1.25, multiway off, bf16 compute, dropout off."""
    base = dict(compute_dtype="bfloat16", dropout=0.0, attention_dropout=0.0,
                multiway=False, max_positions=8194, use_flash_attention=True,
                moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
    base.update(kw)
    return kx.core.config.MagnetoConfig(**base)


def moe_model(dev, kx, seed: int, dtype=torch.bfloat16, **kw):
    """An MoE ``KosmosLanguage`` built on the card from a seeded generator,
    in ``dtype``."""
    from kosmosx_torch.models.language import KosmosLanguage

    cfg = moe_config(kx, **kw)
    g = torch.Generator(device=dev).manual_seed(seed)
    return KosmosLanguage(cfg, generator=g, device=dev).to(dtype), cfg


@contextlib.contextmanager
def routing_spy():
    """Every ``nn/moe._routing`` call's (expert, slot, gate) appended to the
    yielded list while the block runs."""
    from kosmosx_torch.nn import moe

    seen, real = [], moe._routing

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(tuple(t.detach() for t in out))
        return out

    moe._routing = spy
    try:
        yield seen
    finally:
        moe._routing = real


def phase_moe_ffn(dev, kx) -> dict:
    """Phase 11a: ``moe_ffn`` at a full-width layer's shape, (4, 2048, 2048),
    against ``moe_ffn_dense_oracle`` at capacity E (no token dropped): bf16
    (bar 2e-2 of the largest output) and fp32 (TF32 off, bar 1e-4); the
    kept share of (token, choice) pairs at capacity 1.25, and its time
    beside the dense FFN's of ffn 8192 and 16384."""
    from kosmosx_torch.nn import moe
    from kosmosx_torch.nn.decoder import ffn, init_ffn

    cfg = moe_config(kx)
    e, k = cfg.moe_experts, cfg.moe_top_k
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    params = moe.init_moe_ffn(g, cfg.embed_dim, cfg.ffn_dim, e, device=dev)
    x = torch.randn(MOE_BATCH, MOE_SEQ, cfg.embed_dim, generator=g, device=dev)
    out = {}
    for dt, bar in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        xd = x.to(dt)
        with torch.inference_mode():
            y, aux = moe.moe_ffn(params, xd, num_experts=e, top_k=k,
                                 capacity_factor=e, dtype=dt)
            ref = moe.moe_ffn_dense_oracle(params, xd, num_experts=e,
                                           top_k=k)
        err = rel_err(y, ref)
        out[str(dt).split(".")[-1]] = dict(rel_err=err, bar=bar,
                                           aux=aux.item())
        check(err < bar and torch.isfinite(y).all().item(),
              f"moe_ffn {dt} against the dense oracle: {err} >= {bar}")
    xb = x.to(torch.bfloat16)
    with torch.inference_mode(), routing_spy() as seen:
        moe.moe_ffn(params, xb, num_experts=e, top_k=k,
                    capacity_factor=cfg.moe_capacity_factor,
                    dtype=torch.bfloat16)
    kept = (seen[0][2] > 0).float().mean().item()
    cap = moe.moe_capacity(MOE_SEQ, e, k, cfg.moe_capacity_factor)

    def call_moe():
        return moe.moe_ffn(params, xb, num_experts=e, top_k=k,
                           capacity_factor=cfg.moe_capacity_factor,
                           dtype=torch.bfloat16)

    times = {}
    with torch.inference_mode():
        times["moe_ms"] = cuda_ms(call_moe)
        for width in (cfg.ffn_dim, k * cfg.ffn_dim):
            dense = init_ffn(g, cfg.embed_dim, width, device=dev)
            times[f"dense_ffn{width}_ms"] = cuda_ms(
                lambda: ffn(dense, xb, dtype=torch.bfloat16))
            del dense
    out.update(shape=[MOE_BATCH, MOE_SEQ, cfg.embed_dim], experts=e,
               top_k=k, capacity=cap, kept_share=kept, **times,
               nvidia_smi=nvidia_smi_line())
    log("moe_ffn", **out)
    check(0.5 < kept <= 1.0, f"kept share at capacity 1.25: {kept}")
    return out


def decoder_forward_reading(model, cfg, tokens, fa, runs: int = 3) -> dict:
    """``decoder_forward(with_aux=True)``: wall time of each run after a
    warm-up, device time (CUDA events around each run, mean), peak
    memory, and the flash forward's and rotation's launches per run."""
    from kosmosx_torch.nn.decoder import decoder_forward

    with torch.inference_mode():
        decoder_forward(model, tokens, cfg, with_aux=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = fa.flash_fwd_prep.launches = 0
        wall, device = [], []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            logits, aux = decoder_forward(model, tokens, cfg, with_aux=True)
            end.record()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            device.append(start.elapsed_time(end))
        launches = [fa.flash_attention.launches / runs,
                    fa.flash_fwd_prep.launches / runs]
        peak = torch.cuda.max_memory_allocated()
    device_ms = sum(device) / runs
    finite = bool(torch.isfinite(logits).all())
    return dict(wall_s=wall, device_ms=device_ms, peak_mem_bytes=peak,
                flash_launches=launches[0], flash_fwd_prep_launches=launches[1],
                finite=finite, aux=aux.item(), logits_shape=list(logits.shape),
                params=sum(p.numel() for p in model.parameters()))


def phase_moe_forward(dev, kx, fa) -> dict:
    """Phase 11b: the MoE ``decoder_forward(with_aux=True)`` at 4 x 2048,
    bf16: finite logits, aux > 0, the flash forward and its rotation 24
    times each; beside it, as moe_bench does, the dense decoder of the same
    width (ffn 8192) and the active-width one (ffn 16384); then a 2-layer
    fp32 copy at full width, kernel path against plain attention (bar 1e-3,
    routing identical). Returns (readings, the bf16 MoE model, its
    config) for 11c and 11d."""
    from kosmosx_torch.nn.decoder import decoder_forward

    model, cfg = moe_model(dev, kx, SEED + 31)
    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    tokens = torch.randint(4, cfg.vocab_size, (MOE_BATCH, MOE_SEQ),
                           generator=g, device=dev)
    moe = decoder_forward_reading(model, cfg, tokens, fa)
    dense = {}
    for name, ffn_dim in (("dense", cfg.ffn_dim),
                          ("active_width", cfg.moe_top_k * cfg.ffn_dim)):
        m, dcfg = moe_model(dev, kx, SEED + 33, moe_experts=0, ffn_dim=ffn_dim)
        dense[name] = decoder_forward_reading(m, dcfg, tokens, fa)
        del m
        gc.collect()
        torch.cuda.empty_cache()
    ratios = {f"moe_over_{n}_device": moe["device_ms"] / r["device_ms"]
              for n, r in dense.items()}
    ratios.update({f"moe_over_{n}_wall": min(moe["wall_s"]) / min(r["wall_s"])
                   for n, r in dense.items()})

    # the kernel path against plain attention: fp32, 2 layers, full width
    ref_model, rcfg = moe_model(dev, kx, SEED + 34, dtype=torch.float32,
                                compute_dtype="float32", layers=2)
    plain = dataclasses.replace(rcfg, use_flash_attention=False)
    rtok = tokens[:2, :512]
    with torch.inference_mode():
        with routing_spy() as r_kernel:
            out, aux = decoder_forward(ref_model, rtok, rcfg, with_aux=True)
        with routing_spy() as r_plain:
            ref, ref_aux = decoder_forward(ref_model, rtok, plain,
                                           with_aux=True)
    same_routing = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                       for a, b in zip(r_kernel, r_plain))
    err = max_err(out, ref)
    reference = dict(layers=2, dtype="float32", positions=list(rtok.shape),
                     max_abs_err=err, bar=1e-3, aux_abs_err=abs(
                         aux.item() - ref_aux.item()),
                     routing_identical=same_routing)
    del ref_model
    log("moe_forward", moe=moe, **dense, **ratios, reference=reference,
        nvidia_smi=nvidia_smi_line())
    check(moe["finite"] and moe["logits_shape"] == [MOE_BATCH, MOE_SEQ,
                                                    cfg.vocab_size],
          f"MoE logits {moe['logits_shape']}, finite {moe['finite']}")
    check(moe["aux"] > 0, f"MoE aux {moe['aux']}")
    check(moe["flash_launches"] == moe["flash_fwd_prep_launches"]
          == cfg.layers, f"MoE forward flash launches {moe}")
    check(same_routing, "fp32 routing of the kernel path and plain attention "
                        "differ (a near-tied routing choice)")
    check(err < 1e-3, f"MoE kernel vs plain path logits error {err}")
    return dict(moe=moe, **dense, **ratios, reference=reference,
                launches={"flash_fwd": int(moe["flash_launches"]),
                          "flash_fwd_prep": int(moe["flash_fwd_prep_launches"])
                          }), model, cfg


def moe_prompts(dev, cfg, lengths, seed):
    """Right-padded random prompts of ``lengths``: (tokens, lengths)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = max(lengths)
    lens = torch.tensor(lengths, device=dev)
    tokens = torch.randint(4, cfg.vocab_size, (len(lengths), n), generator=g,
                           device=dev)
    tokens[torch.arange(n, device=dev)[None] >= lens[:, None]] = \
        cfg.padding_idx
    return tokens, lens


def phase_moe_generate(dev, fa, da, model, cfg) -> dict:
    """Phase 11c: greedy ``generate_text`` on the bf16 MoE decoder with
    ``decode_attn_kernel=True``: 4 prompts of 192-448 tokens, 32 new
    tokens; ids in the vocabulary, two runs identical, the flash forward
    24 times (the prefill) and the decode kernel 24 times per decode step."""
    from kosmosx_torch.generate.sampler import SamplingConfig, generate_text

    gcfg = dataclasses.replace(cfg, decode_attn_kernel=True)
    tokens, lengths = moe_prompts(dev, cfg, MOE_GEN_LENGTHS, SEED + 35)
    new = 32

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate_text(model, gcfg, tokens,
                            SamplingConfig(max_new_tokens=n, greedy=True),
                            prompt_lengths=lengths)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    fa.flash_attention.launches = da.decode_attention.launches = 0
    first, _ = run(new)
    launches = {"flash": fa.flash_attention.launches,
                "decode": da.decode_attention.launches}
    torch.cuda.reset_peak_memory_stats()
    second, total_s = run(new)
    peak = torch.cuda.max_memory_allocated()
    _, prefill_s = run(1)
    out = dict(requests=len(MOE_GEN_LENGTHS), text_lengths=list(
        MOE_GEN_LENGTHS), new_tokens=new, launches=launches, total_s=total_s,
        prefill_s=prefill_s,
        decode_step_ms=(total_s - prefill_s) / (new - 1) * 1e3,
        tok_per_s=len(MOE_GEN_LENGTHS) * new / total_s, peak_mem_bytes=peak,
        tokens_row0=first[0, :8].tolist(), nvidia_smi=nvidia_smi_line())
    log("moe_generate", **out)
    check(tuple(first.shape) == (len(MOE_GEN_LENGTHS), new),
          f"token shape {tuple(first.shape)}")
    check(bool(((first >= 0) & (first < cfg.vocab_size)).all()),
          "ids in the vocabulary")
    check(torch.equal(first, second), "two MoE generation runs identical")
    check(launches == {"flash": cfg.layers,
                       "decode": cfg.layers * (new - 1)},
          f"MoE generation launches {launches}")
    return out


def phase_moe_engine(dev, kx, fa, da, model, cfg) -> dict:
    """Phase 11d: ``ServeEngine`` on the bf16 MoE decoder, 6i's
    configuration with text only (``max_batch=8, max_prompt_len=512,
    max_len=1024, sync_lag=4``): 16 requests of 64-480 tokens, budgets of
    32-64; every request done with its budget of ids in the vocabulary, the
    decode kernel once per layer and decode dispatch, the flash forward
    once per layer and admission prefill of 256+ positions; TTFT,
    inter-token p50/p99, tok/s, peak memory. Then the engine's exactness on
    a 2-layer fp32 copy at full width (TF32 off): greedy tokens of padded
    admission prefills equal ``generate_text`` on each unpadded prompt
    (pads route nowhere, the cache's routing drops nothing), or differ
    first at an fp32 near-tie below 1e-4 (6j's rule)."""
    from kosmosx_torch.generate import sampler
    from kosmosx_torch.nn import decoder as dec
    from kosmosx_torch.serve import ServeConfig, ServeEngine

    ecfg = dataclasses.replace(cfg, decode_attn_kernel=True)
    vocab = cfg.vocab_size
    g = torch.Generator().manual_seed(SEED + 36)
    lo, hi = ENGINE_TEXT_LENGTHS
    lengths = torch.randint(lo, hi + 1, (MOE_ENGINE_REQUESTS,),
                            generator=g).tolist()
    budgets = torch.randint(32, 65, (MOE_ENGINE_REQUESTS,),
                            generator=g).tolist()
    work = [dict(prompt=torch.randint(4, vocab, (n,), generator=g).tolist(),
                 max_new_tokens=b, at=0 if i < 8 else None)
            for i, (n, b) in enumerate(zip(lengths, budgets))]
    eng = ServeEngine(model, ecfg, ServeConfig(max_batch=8, max_prompt_len=512,
                                               max_len=1024, sync_lag=4),
                      sampler.SamplingConfig(greedy=True), device=dev)
    gc.collect()
    torch.cuda.synchronize()
    eng.reset_counters()
    fa.flash_attention.launches = da.decode_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = drive_engine(eng, work)
    launches = {"flash": fa.flash_attention.launches,
                "decode": da.decode_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    handles = res.pop("handles")
    counts = engine_launch_checks(eng, res.pop("prefill_widths"), launches,
                                  cfg.layers)
    summary = {k: v for k, v in res.items() if k != "ttft_s"}
    out = dict(requests=len(handles), text_lengths=lengths, budgets=budgets,
               **summary, phase_s=dict(eng.phase_s), peak_mem_bytes=peak,
               **counts)
    for i, h in enumerate(handles):
        check(h.done and len(h.tokens) == h.max_new_tokens
              and all(0 <= t < vocab for t in h.tokens),
              f"MoE engine request {i}: done {h.done}, {len(h.tokens)} of "
              f"{h.max_new_tokens} ids")
    check(launches == counts["want"],
          f"MoE engine launches {launches}, want {counts['want']}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # exactness: fp32, 2 layers, full width
    exact, xcfg = moe_model(dev, kx, SEED + 37, dtype=torch.float32,
                            compute_dtype="float32", layers=2,
                            decode_attn_kernel=True)
    gx = torch.Generator().manual_seed(SEED + 38)
    prompts = [torch.randint(4, vocab, (n,), generator=gx).tolist()
               for n in MOE_EXACT_LENGTHS]
    greedy = sampler.SamplingConfig(max_new_tokens=EXACT_NEW, greedy=True)
    with torch.inference_mode():
        want = [sampler.generate_text(exact, xcfg, torch.tensor([p], device=dev),
                                      greedy)[0].tolist() for p in prompts]
    xeng = ServeEngine(exact, xcfg, ServeConfig(max_batch=4, max_prompt_len=512,
                                                max_len=1024, sync_lag=2),
                       device=dev)
    xres = drive_engine(xeng, [dict(prompt=p, max_new_tokens=EXACT_NEW,
                                    at=i // 2) for i, p in enumerate(prompts)])
    got = [h.tokens for h in xres.pop("handles")]

    def ref_logits(r, j):
        """The cached (no-drop) prefill's logits after token j."""
        toks = torch.tensor([prompts[r] + want[r][:j]], device=dev)
        with torch.inference_mode():
            x, _ = dec.forward_embedding(exact, xcfg, toks)
            caches = dec.init_cache(xcfg, 1, toks.shape[1], device=dev)
            return sampler._prefill(exact, xcfg, x, caches, torch.tensor(
                [toks.shape[1]], device=dev))[0]

    ties = exact_tokens("11d fp32 engine", got, want, ref_logits)
    out["exact"] = dict(layers=2, dtype="float32", prompt_lengths=list(
        MOE_EXACT_LENGTHS), new_tokens=EXACT_NEW, prefill_widths=[
        list(w) for w in xres["prefill_widths"]], ties=ties,
        identical=sum(a == b for a, b in zip(got, want)))
    out["nvidia_smi"] = nvidia_smi_line()
    log("moe_engine", **out)
    return dict(out, decode_launches=launches["decode"],
                flash_launches=launches["flash"])


def moe_train_flops(model, cfg, tokens: int, kept: int) -> dict:
    """Model FLOPs of one step counting only the work done: 6 x parameters
    x tokens for every parameter outside the expert stacks, 6 x one
    expert's parameters per kept (token, choice) pair (``kept``, summed
    over layers), plus causal attention as in ``train_flops``."""
    named = dict(model.named_parameters())
    dense = sum(p.numel() for n, p in named.items() if ".experts." not in n)
    per_expert = sum(p.numel() for n, p in named.items()
                     if ".experts." in n) // (cfg.moe_experts * cfg.layers)
    batch = 2
    seq = tokens // batch
    attn = 3 * 2 * 2 * (seq * seq / 2) * cfg.embed_dim * cfg.layers * batch
    return {"dense_params": dense, "params_per_expert_layer": per_expert,
            "flops_kept": 6 * dense * tokens + 6 * per_expert * kept + attn}


def phase_moe_train(dev, kx, fa) -> dict:
    """Phase 11e: ``Trainer.run`` on the MoE decoder with ``lm_loss_fn``:
    2 x 2048, bf16 compute, fp32 parameters, Lion, remat "dots", 8 steps on
    one repeated batch: losses finite, step 8's below step 2's, ``moe_aux``
    in the metrics; the flash forward 48 and dK/dV and dQ 24 times per
    step; after step 1 every expert of layers 0 and 23 has nonzero fc1 and
    fc2 gradients; step time (mean of steps 3-8), tokens/s, peak memory and
    the model-FLOPs share of the kept tokens' work."""
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.nn.decoder import decoder_forward
    from kosmosx_torch.train.data import synthetic_text_batches
    from kosmosx_torch.train.trainer import TrainConfig, Trainer, lm_loss_fn

    cfg = moe_config(kx, remat=True, remat_policy="dots")
    tcfg = TrainConfig(batch_size=2, seq_len=MOE_SEQ, learning_rate=1e-4,
                       optimizer="lion", schedule="constant", warmup_steps=1,
                       total_steps=MOE_TRAIN_STEPS, checkpoint_every=0,
                       log_every=1, seed=SEED + 39)
    trainer = Trainer(lambda g: KosmosLanguage(cfg, generator=g, device=dev),
                      lm_loss_fn(cfg), tcfg, device=dev)
    state = trainer.init_state()
    model = state["params"]
    batch = next(synthetic_text_batches(batch_size=2, seq_len=MOE_SEQ,
                                        vocab_size=cfg.vocab_size, seed=SEED))
    expert_grads = {}
    real_step = trainer.optimizer.step

    def first_step_spy(grads):
        """Step 1's gradients: which experts of layers 0 and L-1 got one."""
        if not expert_grads:
            for li in (0, cfg.layers - 1):
                for leaf in ("fc1", "fc2"):
                    gr = grads[f"layers.{li}.ffn.experts.{leaf}.w"]
                    expert_grads[f"{li}.{leaf}"] = [
                        gr is not None and gr[e].abs().max().item() > 0
                        for e in range(cfg.moe_experts)]
        return real_step(grads)

    trainer.optimizer.step = first_step_spy
    logs, stamps = [], []

    def log_fn(step, m):
        stamps.append(time.perf_counter())
        logs.append(m)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels = flash_counters(fa)
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer.run(itertools.repeat(batch, MOE_TRAIN_STEPS), log_fn=log_fn)
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    mean_s = sum(step_s[2:]) / len(step_s[2:])
    tokens = 2 * MOE_SEQ
    with torch.inference_mode(), routing_spy() as seen:
        decoder_forward(model, torch.as_tensor(batch["input_ids"], device=dev),
                        cfg, with_aux=True)
    kept = sum(int((gate > 0).sum()) for _, _, gate in seen)
    flops = moe_train_flops(model, cfg, tokens, kept)
    losses = [m["loss"] for m in logs]
    aux = [m.get("moe_aux") for m in logs]
    out = dict(steps=MOE_TRAIN_STEPS, batch=[2, MOE_SEQ],
               params=sum(p.numel() for p in model.parameters()),
               losses=losses, moe_aux=aux,
               grad_norms=[m["grad_norm"] for m in logs], step_s=step_s,
               step_s_mean_3_8=mean_s, tokens_per_s=tokens / mean_s,
               kept_pairs=kept, kept_share=kept / (
                   tokens * cfg.moe_top_k * cfg.layers),
               **flops, mfu_kept=flops["flops_kept"] / mean_s / 989e12,
               peak_mem_bytes=peak, launches=launches,
               launches_per_step={k: v / MOE_TRAIN_STEPS
                                  for k, v in launches.items()},
               expert_grads_nonzero=expert_grads,
               nvidia_smi=nvidia_smi_line())
    log("moe_train", **out)
    check(len(logs) == MOE_TRAIN_STEPS, f"{len(logs)} logged steps")
    check(all(math.isfinite(x) for x in losses), "finite MoE losses")
    check(all(a is not None and math.isfinite(a) and a > 0 for a in aux),
          f"moe_aux in every step's metrics: {aux}")
    check(losses[-1] < losses[1], f"MoE loss of step 8 {losses[-1]} below "
                                  f"step 2 {losses[1]}")
    check(len(expert_grads) == 4 and all(all(v) for v in expert_grads.values()),
          f"every expert of layers 0 and 23 has fc1/fc2 gradients: "
          f"{expert_grads}")
    per_step = out["launches_per_step"]
    check(per_step["flash_fwd"] == 2 * cfg.layers
          and per_step["flash_bwd_dkv"] == per_step["flash_bwd_dq"]
          == cfg.layers, f"MoE training launches per step {per_step}")
    return out


def phase_moe_cli(dev, kx) -> dict:
    """Phase 11f, in one child process on the card (``--cli``, one CLI
    ``main`` after another): the training CLI with ``--synthetic
    --moe-experts 4 --layers 2`` at full width (exit 0, ``moe_aux`` in
    every metrics record); a reference ``final_model.pt`` exported here
    from a seeded full-width Kosmos cut to 2 decoder and 2 ViT layers,
    through ``kosmosx_torch.scripts.import_reference --final-model`` (exit
    0, the written parameters the exported model's), then the training CLI
    ``--model kosmos --init-checkpoint`` on its output (exit 0)."""
    import tempfile

    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.train.checkpoint import restore_params
    from kosmosx_torch.utils.ref_checkpoint import save_reference_checkpoint

    cut = ["--layers", "2", "--device", "cuda"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        c = kx.core.config
        kcfg = c.KosmosConfig(decoder=c.MagnetoConfig(layers=2),
                              vision=c.VisionConfig(layers=2))
        src = Kosmos(kcfg, generator=torch.Generator(device=dev).manual_seed(
            SEED + 40), device=dev)
        final = tmp / "final_model.pt"
        t0 = time.perf_counter()
        save_reference_checkpoint(src, str(final))
        export_s = time.perf_counter() - t0
        runs = [("train", [*cut, "--synthetic", "--moe-experts", "4",
                           "--no-multiway", "--seq-len", "512",
                           "--batch-size", "2", "--steps", "3",
                           "--log-every", "1", "--checkpoint-every", "0",
                           "--no-final-save", "--output-dir",
                           str(tmp / "moe"), "--metrics-jsonl",
                           str(tmp / "moe.jsonl")]),
                ("import_reference", ["--final-model", str(final), "--out",
                                      str(tmp / "imported")]),
                ("train", [*cut, "--model", "kosmos", "--vision-layers", "2",
                           "--synthetic", "--seq-len", "256", "--batch-size",
                           "2", "--steps", "2", "--checkpoint-every", "0",
                           "--no-final-save", "--init-checkpoint",
                           str(tmp / "imported"), "--output-dir",
                           str(tmp / "warm")])]
        argv = [sys.executable, str(Path(__file__).resolve()), "--cli"]
        for i, (name, args) in enumerate(runs):
            argv += (["--then"] if i else []) + [name, *args]
        child = run_child(argv)
        moe_run, imported, warm = (child_reports(child["stdout"])
                                   + [{}] * 3)[:3]
        records = jsonl_records(tmp / "moe.jsonl")
        same = None
        if imported.get("rc") == 0:
            written = restore_params(str(tmp / "imported"))
            same = sorted(written) == sorted(n for n, _ in
                                             src.named_parameters()) and all(
                torch.equal(written[n].to(dev), p)
                for n, p in src.named_parameters())
        del src
        gc.collect()
        torch.cuda.empty_cache()
        out["child"] = dict(rc=child["rc"], seconds=child["seconds"],
                            stderr=child["stderr"][-1500:]
                            if child["rc"] else "")
        out["train_moe"] = dict(rc=moe_run.get("rc"),
                                seconds=moe_run.get("seconds"),
                                moe_aux=[r.get("moe_aux") for r in records],
                                losses=[r.get("loss") for r in records])
        out["import_reference"] = dict(
            rc=imported.get("rc"), seconds=imported.get("seconds"),
            file_bytes=final.stat().st_size, export_s=export_s,
            params_identical=same)
        out["train_init_checkpoint"] = dict(rc=warm.get("rc"),
                                            seconds=warm.get("seconds"))
    log("moe_cli", **out)
    t = out["train_moe"]
    check(child["rc"] == 0, f"the MoE CLI child: {out['child']}")
    check(t["rc"] == 0 and len(t["moe_aux"]) == 3
          and all(a is not None and a > 0 for a in t["moe_aux"]),
          f"training CLI --moe-experts 4: {t}")
    check(out["import_reference"]["rc"] == 0
          and out["import_reference"]["params_identical"],
          f"import_reference --final-model: {out['import_reference']}")
    check(out["train_init_checkpoint"]["rc"] == 0,
          f"training CLI --init-checkpoint: {out['train_init_checkpoint']}")
    return out


def phase_ref_roundtrip(dev, kx, model, cfg) -> dict:
    """Phase 11g: phase 5's bf16 flagship through
    ``state_dict_from_kosmos_params`` -> ``kosmos_params_from_state_dict``
    in memory on the card: the re-imported model's logits bit-identical to
    the model's on the same 2 x (1920 + 64) inputs."""
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.utils.ref_checkpoint import (
        kosmos_params_from_state_dict, state_dict_from_kosmos_params)

    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    tokens = torch.randint(4, cfg.decoder.vocab_size, (2, 1920), generator=g,
                           device=dev)
    images = pixels(2, g, dev)
    t0 = time.perf_counter()
    sd = state_dict_from_kosmos_params(model)
    keys = len(sd)
    tree = kosmos_params_from_state_dict(sd, cfg)
    del sd
    back = Kosmos(cfg, params=tree).to(torch.bfloat16)
    del tree
    torch.cuda.synchronize()
    roundtrip_s = time.perf_counter() - t0
    with torch.inference_mode():
        want = model.apply(tokens, images)
        got = back.apply(tokens, images)
    identical = torch.equal(got, want)
    names_same = sorted(n for n, _ in back.named_parameters()) == \
        sorted(n for n, _ in model.named_parameters())
    out = dict(roundtrip_s=roundtrip_s, keys=keys, logits_identical=identical,
        max_abs_err=max_err(got, want), names_same=names_same,
        nvidia_smi=nvidia_smi_line())
    log("ref_roundtrip", **out)
    check(names_same, "re-imported parameter names")
    check(identical, f"re-imported logits differ: {out['max_abs_err']}")
    return out


# ---------------------------------------------------------------------------
# the modality zoo (phases 12a-12e)
# ---------------------------------------------------------------------------

ZOO_TEXT = 1024                      # 12a's text tokens per row
ZOO_PAD = 96                         # row 1's right padding
ZOO_AUDIO = 16000                    # 1 s at 16 kHz: 49 wav2vec2 frames
ZOO_CLIPS = (2, 3, 16, 112, 112)
ZOO_ANY_AUDIO = 204400               # 511 unified frames + CLS = 512 tokens
ZOO_ANY_CLIP = (1, 3, 16, 112, 112)  # 392 unified tubes
ZOO_ANY_TEXT = 256
ZOO_ANY_ARRAY = (1, 64, 100)         # an "any" input: 6400 values
ZOO_BAR = 1e-3                       # kernel path against plain, fp32
R3D18_BAR = 2e-4                     # tests/test_hf_audio_video.py:196


def zoo_configs(kx) -> dict:
    """12a's model: the flagship decoder (bf16, dropout off), ViT-L/14 at
    224 with the default resampler, wav2vec2-base, r3d18; the towers at
    their JAX default, fp32."""
    c = kx.core.config
    return dict(decoder=flagship_config(kx).decoder, vision=c.VisionConfig(),
                resampler=c.ResamplerConfig(),
                audio=c.AudioConfig(arch="wav2vec2"),
                video=c.VideoConfig(arch="r3d18"))


def zoo_inputs(dev, dcfg, seed: int) -> dict:
    """2 rows of ``ZOO_TEXT`` tokens (BOS first, row 1 right-padded by
    ``ZOO_PAD``), 2 images, 2 waveforms of ``ZOO_AUDIO`` samples, 2 clips."""
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(4, dcfg.vocab_size, (2, ZOO_TEXT), generator=g,
                           device=dev)
    tokens[:, 0] = 0
    tokens[1, -ZOO_PAD:] = dcfg.padding_idx
    return dict(text_tokens=tokens, images=pixels(2, g, dev),
                audios=torch.randn(2, ZOO_AUDIO, generator=g, device=dev),
                videos=torch.randn(ZOO_CLIPS, generator=g, device=dev))


def zoo_tower_times(model, x: dict, media_len: int) -> dict:
    """Device time of each provided tower (its embedding block), of the
    decoder over the spliced length (layers and logits on a stand-in input
    of that shape with ``x``'s padding segments), and of the whole
    ``apply``."""
    from kosmosx_torch.nn import decoder as dec

    dcfg = model.decoder_config
    out = {}
    with torch.inference_mode():
        for name, key in (("image", "images"), ("audio", "audios"),
                          ("video", "videos")):
            if key in x:
                out[f"{name}_ms"] = cuda_ms(
                    lambda: model.media_blocks(**{key: x[key]}))
        tokens = x["text_tokens"]
        b, _ = tokens.shape
        g = torch.Generator(device=tokens.device).manual_seed(SEED + 59)
        h = torch.randn(b, tokens.shape[1] + media_len, dcfg.embed_dim,
                        generator=g, device=tokens.device).to(dcfg.dtype)
        valid = torch.cat([tokens[:, :1] != dcfg.padding_idx,
                           tokens.new_ones((b, media_len), dtype=torch.bool),
                           tokens[:, 1:] != dcfg.padding_idx], dim=1)
        seg = torch.where(valid, 0, -1).to(torch.int32)
        out["decoder_ms"] = cuda_ms(lambda: dec.output_logits(
            model["decoder"], dec.run_layers(model["decoder"], h, dcfg,
                                             segment_ids=seg), dcfg))
        out["apply_ms"] = cuda_ms(lambda: model.apply(**x))
    return out


def phase_zoo_conditional(dev, kx, fa) -> tuple:
    """Phase 12a: ``KosmosConditional`` with all four modalities at full
    width: the flagship decoder (bf16 compute over fp32 parameters),
    ViT-L/14 with the default resampler, wav2vec2-base and r3d18 (fp32).
    Batch 2 of ``ZOO_TEXT`` text tokens, one row right-padded, ``ZOO_AUDIO``
    samples of audio and ``ZOO_CLIPS`` clips: logits (2, ZOO_TEXT + 66,
    32002), finite, the flash forward and its rotation 24 times in
    ``apply``; the same model text-only; device time per tower, of the
    decoder and of ``apply``; peak memory. Then the same weights and inputs
    with the decoder in fp32, the kernel path against plain attention (bar
    1e-3, phase 5's). Returns (readings, model, inputs) for 12b-12d."""
    from kosmosx_torch.models.conditional import KosmosConditional

    cfg = zoo_configs(kx)
    dcfg = cfg["decoder"]
    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    t0 = time.perf_counter()
    model = KosmosConditional(("text", "image", "audio", "video"), **cfg,
                              generator=g, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    x = zoo_inputs(dev, dcfg, SEED + 52)
    media_len = model.image_embed_len + 2
    with torch.inference_mode():
        model.apply(**x)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = fa.flash_fwd_prep.launches = 0
        t0 = time.perf_counter()
        logits = model.apply(**x)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {"flash_fwd": fa.flash_attention.launches,
                    "flash_fwd_prep": fa.flash_fwd_prep.launches}
        peak = torch.cuda.max_memory_allocated()
        text_only = model.apply(x["text_tokens"])
    shape, finite = list(logits.shape), bool(torch.isfinite(logits).all())
    text_shape = list(text_only.shape)
    text_finite = bool(torch.isfinite(text_only).all())
    del logits, text_only
    times = zoo_tower_times(model, x, media_len)

    fp32 = dataclasses.replace(dcfg, compute_dtype="float32")
    with torch.inference_mode():
        model.decoder_config = fp32
        fa.flash_attention.launches = 0
        out = model.apply(**x)
        fp32_launches = fa.flash_attention.launches
        model.decoder_config = dataclasses.replace(
            fp32, use_flash_attention=False)
        ref = model.apply(**x)
        model.decoder_config = dcfg
    err = max_err(out, ref)
    del out, ref
    reading = dict(params=model.num_params, init_s=init_s, wall_s=wall_s,
                   logits_shape=shape, finite=finite,
                   text_only_shape=text_shape, text_only_finite=text_finite,
                   launches=launches, peak_mem_bytes=peak, **times,
                   reference=dict(dtype="float32", layers=dcfg.layers,
                                  flash_launches=fp32_launches,
                                  max_abs_err=err, bar=ZOO_BAR),
                   nvidia_smi=nvidia_smi_line())
    log("zoo_conditional", **reading)
    want = [2, ZOO_TEXT + media_len, dcfg.vocab_size]
    check(shape == want and finite,
          f"12a logits {shape} (want {want}), finite {finite}")
    check(text_shape == [2, ZOO_TEXT, dcfg.vocab_size] and text_finite,
          f"12a text-only logits {text_shape}, finite {text_finite}")
    check(launches["flash_fwd"] == launches["flash_fwd_prep"] == dcfg.layers,
          f"12a flash launches in apply {launches}")
    check(fp32_launches == dcfg.layers,
          f"12a fp32 kernel path: {fp32_launches} flash launches")
    check(err < ZOO_BAR, f"12a kernel vs plain path logits error {err}")
    return reading, model, x


def phase_zoo_lean(dev, kx, model12a) -> dict:
    """Phase 12b: the lean towers, the framed ``AudioConfig()`` and the lean
    ``VideoConfig()`` at 112², on 12a's decoder, with 12a's text, audio and
    clips: logits (2, ZOO_TEXT + 2, 32002), finite; device time per tower."""
    from kosmosx_torch.core import initializers as init
    from kosmosx_torch.core.params import to_tree
    from kosmosx_torch.models.conditional import KosmosConditional
    from kosmosx_torch.nn.audio import init_audio_encoder
    from kosmosx_torch.nn.video import init_video_encoder

    c = kx.core.config
    dcfg = model12a.decoder_config
    acfg, vcfg = c.AudioConfig(), c.VideoConfig()
    g = torch.Generator(device=dev).manual_seed(SEED + 53)
    d = dcfg.embed_dim
    params = {
        "decoder": to_tree(model12a["decoder"]),
        "audio_enc": init_audio_encoder(g, acfg, dev),
        "audio_proj": {"w": init.magneto_output_projection(
            g, (acfg.hidden_dim, d), dev)},
        "video_enc": init_video_encoder(g, vcfg, dev),
        "video_proj": {"w": init.magneto_output_projection(
            g, (vcfg.hidden_dim, d), dev)}}
    model = KosmosConditional(("text", "audio", "video"), decoder=dcfg,
                              audio=acfg, video=vcfg, params=params)
    x = zoo_inputs(dev, dcfg, SEED + 52)
    del x["images"]
    with torch.inference_mode():
        logits = model.apply(**x)
        frames = list(model.media_blocks(audios=x["audios"])[0].shape)
    shape, finite = list(logits.shape), bool(torch.isfinite(logits).all())
    del logits
    times = zoo_tower_times(model, x, 2)
    reading = dict(tower_params={
        k: sum(p.numel() for p in model[k].parameters())
        for k in ("audio_enc", "video_enc")}, audio_block=frames,
        logits_shape=shape, finite=finite, **times,
        nvidia_smi=nvidia_smi_line())
    log("zoo_lean", **reading)
    want = [2, ZOO_TEXT + 2, dcfg.vocab_size]
    check(shape == want and finite,
          f"12b logits {shape} (want {want}), finite {finite}")
    return reading


def phase_zoo_any(dev, kx, fa, model12a) -> dict:
    """Phase 12c: ``KosmosAny`` on 12a's decoder. Unified
    (``UnifiedConfig(use_flash_attention=True)``): an image (257 tokens,
    plain attention), ``ZOO_ANY_AUDIO`` samples (l = 512: the non-causal
    flash kernel without xPos in every trunk layer), a ``ZOO_ANY_CLIP``
    clip (393 tokens) and an "any" array, each through the trunk with the
    kernel against the plain trunk (bar 1e-3), then ``apply`` over all
    four: the flash forward 24 (decoder) + 6 (the audio trunk) times, its
    rotation 24. Per-modality towers: an image, a waveform and a clip
    detected by ``prepare_media`` and an "any" array, registered on the
    card; every registered leaf on the card; logits finite."""
    from kosmosx_torch.core.params import to_tree
    from kosmosx_torch.models.any_modality import KosmosAny
    from kosmosx_torch.nn.unified import UnifiedConfig, unified_encode

    dcfg = model12a.decoder_config
    g = torch.Generator(device=dev).manual_seed(SEED + 55)
    ucfg = UnifiedConfig(use_flash_attention=True)
    uni = KosmosAny(dcfg, unified=True, unified_config=ucfg, generator=g,
                    params={"decoder": to_tree(model12a["decoder"])})
    rng = torch.Generator().manual_seed(SEED + 56)   # host data, as a user's
    media = [("image", (torch.rand(1, 3, 224, 224, generator=rng) * 255)
              .to(torch.uint8).numpy()),
             ("audio", torch.randn(1, ZOO_ANY_AUDIO, generator=rng).numpy()),
             ("video", torch.randn(ZOO_ANY_CLIP, generator=rng).numpy()),
             ("any", torch.randn(ZOO_ANY_ARRAY, generator=rng).numpy())]
    prepared = uni.prepare_media(media)
    plain = dataclasses.replace(ucfg, use_flash_attention=False)
    trunk = {}
    with torch.inference_mode():
        for modality, xm in prepared:
            fa.flash_attention.launches = 0
            out = unified_encode(uni["unified_enc"], xm, modality, ucfg)
            n = fa.flash_attention.launches
            ref = unified_encode(uni["unified_enc"], xm, modality, plain)
            trunk[modality] = dict(
                flash_launches=n, max_abs_err=max_err(out, ref),
                ms=cuda_ms(lambda: unified_encode(
                    uni["unified_enc"], xm, modality, ucfg)),
                plain_ms=cuda_ms(lambda: unified_encode(
                    uni["unified_enc"], xm, modality, plain)))
        tokens = torch.randint(4, dcfg.vocab_size, (1, ZOO_ANY_TEXT),
                               generator=g, device=dev)
        fa.flash_attention.launches = fa.flash_fwd_prep.launches = 0
        logits = uni.apply(tokens, media=prepared)
        torch.cuda.synchronize()
        uni_launches = {"flash_fwd": fa.flash_attention.launches,
                        "flash_fwd_prep": fa.flash_fwd_prep.launches}
        uni_shape = list(logits.shape)
        uni_finite = bool(torch.isfinite(logits).all())
    del logits

    towers = KosmosAny(dcfg, generator=g,
                       params={"decoder": to_tree(model12a["decoder"])})
    raw = [(None, (torch.rand(1, 3, 480, 640, generator=rng) * 255)
            .to(torch.uint8).numpy()),
           (None, torch.randn(1, ZOO_AUDIO, generator=rng).numpy()),
           (None, torch.randn(ZOO_ANY_CLIP, generator=rng).numpy()),
           ("any", torch.randn(ZOO_ANY_ARRAY, generator=rng).numpy())]
    detected = towers.prepare_media(raw)
    with torch.inference_mode():
        logits = towers.apply(tokens, media=detected)
        torch.cuda.synchronize()
        tower_shape = list(logits.shape)
        tower_finite = bool(torch.isfinite(logits).all())
    del logits
    devices = collections.Counter(
        str(p.device) for m in (uni, towers) for p in m.parameters())
    reading = dict(
        unified=dict(trunk=trunk, launches=uni_launches,
                     logits_shape=uni_shape, finite=uni_finite,
                     registered=sorted(uni._modules)),
        towers=dict(detected=[m for m, _ in detected],
                    registered=sorted(towers._modules),
                    logits_shape=tower_shape, finite=tower_finite),
        leaf_devices=dict(devices), nvidia_smi=nvidia_smi_line())
    log("zoo_any", **reading)
    vocab = dcfg.vocab_size
    check(trunk["audio"]["flash_launches"] == ucfg.layers,
          f"12c: the 512-token trunk took the flash kernel "
          f"{trunk['audio']['flash_launches']} times")
    for modality, r in trunk.items():
        if modality != "audio":
            check(r["flash_launches"] == 0, f"12c {modality}: {r}")
        check(r["max_abs_err"] < ZOO_BAR,
              f"12c {modality} trunk kernel vs plain error {r['max_abs_err']}")
    check(uni_launches == {"flash_fwd": dcfg.layers + ucfg.layers,
                           "flash_fwd_prep": dcfg.layers},
          f"12c unified apply launches {uni_launches}")
    check(uni_shape == [1, ZOO_ANY_TEXT + 4, vocab] and uni_finite,
          f"12c unified logits {uni_shape}, finite {uni_finite}")
    check([m for m, _ in detected] == ["image", "audio", "video", "any"],
          f"12c detected {[m for m, _ in detected]}")
    check(tower_shape == [1, ZOO_ANY_TEXT + 64 + 3, vocab] and tower_finite,
          f"12c tower logits {tower_shape}, finite {tower_finite}")
    check(all(d.startswith("cuda") for d in devices),
          f"12c leaves off the card: {dict(devices)}")
    return reading


def zoo_grads(model, x, freeze=("clip",)) -> tuple:
    """Mean cross-entropy over the text positions (the media block sits
    after BOS) and its gradients, CLIP frozen."""
    from kosmosx_torch.train.loss import multimodal_next_token_loss
    from kosmosx_torch.train.trainer import value_and_grad

    media_len = model.image_embed_len + 2
    pad = model.decoder_config.padding_idx

    def loss_fn(m, batch, rng):
        return multimodal_next_token_loss(
            m.apply(**batch), batch["text_tokens"], media_len, 1, pad)

    (loss, _), grads = value_and_grad(loss_fn, model, x, freeze=freeze)
    return loss, grads


ZOO_GRAD_GROUPS = ("audio_proj", "video_proj", "audio_enc", "video_enc",
                   "resampler", "image_proj", "decoder.layers.0.",
                   "decoder.layers.23.")


def phase_zoo_grad(dev, fa, model, x) -> dict:
    """Phase 12d: one gradient of the mean cross-entropy over the text
    positions through 12a's model and inputs, CLIP frozen: finite, non-zero
    in each group of ``ZOO_GRAD_GROUPS``, every leaf of a tower (a decoder
    layer's multiway B expert takes none: the model passes no split, as
    JAX's does); the backward's pre-pass, dK/dV and
    dQ 24 times each, the forward and its rotation 24; peak memory. Then the
    decoder in fp32, the kernel path against plain attention: every
    gradient within 1e-3 of its largest value (phase 8's bar), where that is
    below 1e-4 of its top-level subtree's largest gradient (a key bias
    without xPos, zero but for rounding) within 1e-3 of 1e-4 of it."""
    dcfg = model.decoder_config
    kernels = flash_counters(fa)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = zoo_grads(model, x)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: fn.launches for k, fn in kernels.items()}
    groups = {}
    for prefix in ZOO_GRAD_GROUPS:
        gs = [g for n, g in grads.items() if n.startswith(prefix)]
        groups[prefix] = dict(
            leaves=len(gs), with_grad=sum(g is not None for g in gs),
            finite=all(bool(torch.isfinite(g).all()) for g in gs
                       if g is not None),
            max_abs=max((g.abs().max().item() for g in gs if g is not None),
                        default=0.0))
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values()
                 if g is not None)
    bf16_loss = loss.item()
    del grads

    fp32 = dataclasses.replace(dcfg, compute_dtype="float32")
    model.decoder_config = fp32
    for fn in kernels.values():
        fn.launches = 0
    loss, got = zoo_grads(model, x)
    fp32_launches = {k: fn.launches for k, fn in kernels.items()}
    model.decoder_config = dataclasses.replace(fp32, use_flash_attention=False)
    ref_loss, want = zoo_grads(model, x)
    model.decoder_config = dcfg
    model.set_trainable(freeze=tuple(model._modules))
    top = collections.defaultdict(float)
    for n, g in want.items():
        if g is not None:
            key = n.split(".", 1)[0]
            top[key] = max(top[key], g.abs().max().item())
    worst, worst_name = 0.0, None
    for n, g in want.items():
        if g is None:
            check(got[n] is None, f"12d {n}: gradient only on the kernel path")
            continue
        scale = max(g.abs().max().item(), 1e-4 * top[n.split(".", 1)[0]])
        err = max_err(got[n], g) / max(scale, 1e-30)
        if err > worst:
            worst, worst_name = err, n
    loss_err = abs(loss.item() - ref_loss.item())
    del got, want
    reading = dict(loss=bf16_loss, grad_s=grad_s, finite=finite,
                   groups=groups, launches=launches, peak_mem_bytes=peak,
                   reference=dict(dtype="float32", launches=fp32_launches,
                                  loss=ref_loss.item(), loss_abs_err=loss_err,
                                  max_rel_grad_err=worst,
                                  worst_param=worst_name, bar=ZOO_BAR),
                   nvidia_smi=nvidia_smi_line())
    log("zoo_grad", **reading)
    check(finite, "12d gradients finite")
    for prefix, r in groups.items():
        every = r["with_grad"] == r["leaves"] or prefix.startswith("decoder")
        check(r["with_grad"] > 0 and every and r["finite"] and r["max_abs"] > 0,
              f"12d gradient of {prefix}: {r}")
    n = dcfg.layers
    check(launches["flash_bwd_prep"] == launches["flash_bwd_dkv"]
          == launches["flash_bwd_dq"] == launches["flash_fwd"]
          == launches["flash_fwd_prep"] == n, f"12d flash launches {launches}")
    check(all(fp32_launches[k] == n for k in ("flash_fwd", "flash_bwd_prep",
                                              "flash_bwd_dkv", "flash_bwd_dq")),
          f"12d fp32 kernel path launches {fp32_launches}")
    check(loss_err < ZOO_BAR * max(1.0, abs(ref_loss.item())),
          f"12d kernel vs plain loss {loss.item()} vs {ref_loss.item()}")
    check(worst < ZOO_BAR,
          f"12d kernel vs plain gradient {worst_name}: {worst}")
    return reading


class R3D18Oracle(torch.nn.Module):
    """torchvision's ``r3d_18`` module layout and state-dict keys without
    its head (``torchvision.models.video.resnet``: ``BasicStem``,
    ``Conv3DSimple``, ``BasicBlock``): a clip's mean over (T, H, W) of the
    last stage."""

    def __init__(self, widths=(64, 128, 256, 512)):
        super().__init__()
        nn = torch.nn

        def conv3(cin, cout, stride=1):
            return nn.Conv3d(cin, cout, 3, stride=stride, padding=1,
                             bias=False)

        class Block(nn.Module):
            def __init__(self, cin, planes, stride):
                super().__init__()
                self.conv1 = nn.Sequential(conv3(cin, planes, stride),
                                           nn.BatchNorm3d(planes),
                                           nn.ReLU(inplace=True))
                self.conv2 = nn.Sequential(conv3(planes, planes),
                                           nn.BatchNorm3d(planes))
                self.relu = nn.ReLU(inplace=True)
                self.downsample = None
                if stride != 1 or cin != planes:
                    self.downsample = nn.Sequential(
                        nn.Conv3d(cin, planes, 1, stride=stride, bias=False),
                        nn.BatchNorm3d(planes))

            def forward(self, x):
                res = x if self.downsample is None else self.downsample(x)
                return self.relu(self.conv2(self.conv1(x)) + res)

        self.stem = nn.Sequential(
            nn.Conv3d(3, widths[0], (3, 7, 7), stride=(1, 2, 2),
                      padding=(1, 3, 3), bias=False),
            nn.BatchNorm3d(widths[0]), nn.ReLU(inplace=True))
        cin = widths[0]
        for i, w in enumerate(widths):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                Block(cin, w, 1 if i == 0 else 2), Block(w, w, 1)))
            cin = w

    def forward(self, x):
        x = self.stem(x)
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.mean(dim=(2, 3, 4))


def randomize_bn(model, g: torch.Generator) -> None:
    """Random BatchNorm statistics and affines, so the fold is exercised
    (tests/test_hf_audio_video.py:173-187)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                kw = dict(generator=g, device=m.running_mean.device)
                m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                                 **kw) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, **kw)
                                    + 0.5)
                m.weight.copy_(torch.rand(m.weight.shape, **kw) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, **kw) * 0.1)


def phase_zoo_r3d18(dev, kx) -> dict:
    """Phase 12e: an r3d_18 oracle with torchvision's layout at its real
    widths (64-512) and random BatchNorm statistics, on the card, converted
    by ``r3d18_params_from_state_dict``: the port's encoder against the
    oracle on ``ZOO_CLIPS`` clips in fp32 with TF32 off, every output within
    2e-4 absolute plus 2e-4 relative (``assert_allclose``'s rule); both
    timed."""
    from kosmosx_torch.core.params import ParamTree
    from kosmosx_torch.nn.video import video_encoder
    from kosmosx_torch.utils.hf_convert import r3d18_params_from_state_dict

    g = torch.Generator(device=dev).manual_seed(SEED + 57)
    torch.manual_seed(SEED + 57)
    oracle = R3D18Oracle().to(dev).eval()
    randomize_bn(oracle, g)
    t0 = time.perf_counter()
    params = ParamTree(r3d18_params_from_state_dict(oracle, device=dev))
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    cfg = kx.core.config.VideoConfig(arch="r3d18")
    clips = torch.randn(ZOO_CLIPS, generator=g, device=dev)
    with torch.inference_mode():
        ref = oracle(clips)
        out = video_encoder(params, clips, cfg)
        excess = ((out - ref).abs() - R3D18_BAR * ref.abs()).max().item()
        reading = dict(
            shape=list(out.shape), max_abs_err=max_err(out, ref),
            max_excess_over_rtol=excess, bar=R3D18_BAR, convert_s=convert_s,
            ms=cuda_ms(lambda: video_encoder(params, clips, cfg)),
            oracle_ms=cuda_ms(lambda: oracle(clips)),
            tf32=[torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32],
            nvidia_smi=nvidia_smi_line())
    log("zoo_r3d18", **reading)
    check(reading["shape"] == [ZOO_CLIPS[0], 512], f"12e shape {reading}")
    check(not any(reading["tf32"]), "12e needs TF32 off")
    check(excess <= R3D18_BAR, f"12e r3d18 against its oracle: {reading}")
    return reading


def decode_entry(entry, rl, decode) -> dict:
    """The decode kernel's entry: bf16 at the kernels line's shape, with the
    int8 cache's time and bound and generation's shape beside it."""
    out = entry("decode_attention", "decode_attention.cu",
                "kosmosx_tpu/ops/decode_attention.py:77",
                decode["bf16"]["max_abs_err"], decode["bf16"],
                rl.decode_work(DECODE_KV_LEN, 32, 64))
    for prefix, lens in (("", DECODE_KV_LEN), ("gen_", GEN_DECODE_KV_LEN)):
        for name, work in (
                ("bf16", rl.decode_work(lens, 32, 64)),
                ("int8", rl.decode_work(lens, 32, 64, kv_itemsize=1,
                                        scales=True))):
            case = decode[prefix + name]
            key = prefix + name
            if key != "bf16":
                out.update({f"{key}_ms": case["ms"],
                            f"{key}_launch_ms": case["launch_ms"],
                            f"{key}_plain_ms": case["plain_ms"],
                            f"{key}_bound_ms": rl.bound(work)[0]})
    out["gen_bf16_library_ms"] = decode["gen_bf16"].get("library_ms")
    return out


# ---------------------------------------------------------------------------
# phases 13a-13c: context parallelism and data parallelism across processes
# ---------------------------------------------------------------------------

RANKS = 2                 # ranks as child processes on the one card (gloo)
RING_HEADS = 32
RING_SEQ = 16384          # 13a: 2 x 8192 positions, bf16
RING_FP32_SEQ = 2048      # 13a: 2 x 1024 positions, fp32
SP_SEQ = 8192             # 13b: one row over 2 ranks
SP_LAYERS = 2
SP_LR = 1e-3              # 13b: SGD
RING_GROUPS = (("flash_bwd_prep", "flash_bwd_prep"),
               ("flash_bwd_dkv", "flash_bwd_dkv"),
               ("flash_bwd_dq", "flash_bwd_dq"),
               ("flash_fwd_prep", "flash_fwd_prep"),
               ("flash_fwd", "flash_fwd"))


def run_ranks(args, timeout: int = 900, env=None) -> list:
    """``args`` in RANKS child processes under torchrun's variables
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` on a free port): ``[(rc, stdout,
    stderr)]`` by rank. Every rank is killed if one outlives ``timeout``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = Path(__file__).resolve().parent
    procs = []
    for rank in range(RANKS):
        child_env = {**os.environ, **(env or {}), "RANK": str(rank),
                     "WORLD_SIZE": str(RANKS), "LOCAL_RANK": str(rank),
                     "LOCAL_WORLD_SIZE": str(RANKS),
                     "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(args, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      cwd=root, env=child_env))
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=timeout)
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def rank_reports(phase: str, outs) -> list:
    """Each rank's JSON report of task ``phase`` (its ``{"rank"`` line of
    that task); a rank that failed fails the phase."""
    reports = []
    for rank, (rc, out, err) in enumerate(outs):
        lines = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith('{"rank"')]
        lines = [r for r in lines if r.get("task") == phase]
        check(rc == 0 and lines, f"{phase} rank {rank}: rc {rc}, "
                                 f"{err[-2000:]}")
        reports.append(lines[-1])
    return reports


# the rank tasks that run in one pair of child processes, one after
# another (a process takes seconds to reach the card and build its tasks'
# imports): 13a-13b, and 14a-14e
RANK_GROUPS = (("ring", "sp"), ("tp_train", "ep", "pp", "tp_serve", "tp_w8"))
_RANK_RUNS: dict = {}


def task_reports(task: str) -> list:
    """Each rank's report of ``task``: its group of RANK_GROUPS runs in
    RANKS child processes at the first call for one of its tasks."""
    group = next(g for g in RANK_GROUPS if task in g)
    if group not in _RANK_RUNS:
        _RANK_RUNS[group] = run_ranks(
            [sys.executable, str(Path(__file__).resolve()), "--rank",
             ",".join(group)], timeout=1100)
    return rank_reports(task, _RANK_RUNS[group])


def flash_device_ms(prof) -> dict:
    """Device time (ms) of the flash kernels by name in a profile; the
    rest (copies of the host-staged transport, merges) apart."""
    groups = dict.fromkeys([g for g, _ in RING_GROUPS] + ["other"], 0.0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        low = evt.key.lower()
        group = next((g for g, key in RING_GROUPS if key in low), "other")
        groups[group] += us / 1e3
    return groups


def ring_inputs(dev, length: int, dtype, segs: bool):
    """q, k, v, the cotangent (1, RING_HEADS, length, 64) and packed
    segment ids (1, length): a document break at 3/8 of the sequence and a
    padded (-1) tail of 777 positions."""
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    q, k, v, do = (torch.randn((1, RING_HEADS, length, 64), generator=g,
                               device=dev).to(dtype) for _ in range(4))
    seg = None
    if segs:
        pos = torch.arange(length, device=dev)[None]
        seg = (pos >= length * 3 // 8).int()
        seg = torch.where(pos >= length - 777, -1, seg).int()
    return q, k, v, do, seg


def rank_ring(dev) -> dict:
    """Phase 13a on one rank: the contiguous and the zigzag ring, causal,
    with and without packed segment ids, forward and backward on this
    rank's shard; held against the single-process path on the whole
    sequence (the flash kernels in bf16, the plain versions in fp32), with
    the kernels' launches and device time apart from the transport."""
    import torch.distributed as dist

    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.parallel import ring_attention as ra
    from kosmosx_torch.parallel.mesh import build_mesh

    mesh = build_mesh((RANKS,), ("sequence",))
    group, i = mesh.get_group("sequence"), mesh.get_local_rank("sequence")
    counters = flash_counters(fa)
    cases = {}
    for dtype, length in ((torch.bfloat16, RING_SEQ),
                          (torch.float32, RING_FP32_SEQ)):
        for schedule in ("ring", "zigzag"):
            for segs in (False, True):
                q, k, v, do, seg = ring_inputs(dev, length, dtype, segs)
                kw = dict(causal=True, sm_scale=64 ** -0.5,
                          q_segment_ids=seg, kv_segment_ids=seg)
                if dtype == torch.bfloat16:
                    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
                    o_ref = fa.flash_attention(qr, kr, vr, **kw)
                    o_ref.backward(do)
                    ref = (o_ref.detach(), qr.grad, kr.grad, vr.grad)
                else:
                    o_ref, stat_l, m = fa.flash_attention_plain(q, k, v, **kw)
                    ref = (o_ref, *fa.flash_attention_bwd_plain(
                        q, k, v, o_ref, stat_l, m, do, **kw))
                s, lq = RANKS, length // RANKS

                def local(t, dim=2):
                    if schedule == "zigzag":
                        t = ra.zigzag_permute(t, s, axis=dim)
                    return t.narrow(dim, i * lq, lq)

                qs, ks, vs = (local(t).clone().requires_grad_()
                              for t in (q, k, v))
                sg = None if seg is None else local(seg, 1).contiguous()
                dos = local(do).contiguous()

                def run():
                    qs.grad = ks.grad = vs.grad = None
                    if schedule == "zigzag":
                        o = ra.zigzag_ring_flash_attention(
                            qs, ks, vs, group, sm_scale=kw["sm_scale"],
                            q_segment_ids=sg, kv_segment_ids=sg)
                    else:
                        o = ra.ring_flash_attention(
                            qs, ks, vs, group, causal=True,
                            sm_scale=kw["sm_scale"], q_segment_ids=sg,
                            kv_segment_ids=sg)
                    o.backward(dos)
                    return o

                for fn in counters.values():
                    fn.launches = 0
                dist.barrier(group)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o = run()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                launches = {n: fn.launches for n, fn in counters.items()}
                got = (o.detach(), qs.grad, ks.grad, vs.grad)
                errs = {n: (max_err(a, local(r)), rel_err(a, local(r)))
                        for n, a, r in zip(("o", "dq", "dk", "dv"), got, ref)}
                key = (f"{schedule}_{'segments' if segs else 'plain'}_"
                       f"{str(dtype).split('.')[-1]}")
                case = dict(seq=length, shard=lq, max_abs_err={
                    n: e[0] for n, e in errs.items()},
                    max_rel_err={n: e[1] for n, e in errs.items()},
                    launches=launches, wall_ms=wall_ms)
                if dtype == torch.bfloat16 and not segs:
                    dist.barrier(group)
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        run()
                        torch.cuda.synchronize()
                    case["device_ms"] = flash_device_ms(prof)
                cases[key] = case
                del q, k, v, do, ref, got, o, qs, ks, vs, dos
                torch.cuda.empty_cache()
    # each rank's kernel work alone: its pairs' shapes timed while the
    # other rank waits (in the ring the ranks' kernels share the card)
    alone = {}
    for turn in range(RANKS):
        dist.barrier(group)
        if turn == i:
            alone = {sched: ring_pair_ms(dev, fa, pairs)
                     for sched, pairs in ring_pairs(i, RING_SEQ).items()}
        torch.cuda.synchronize()
    dist.barrier(group)
    return {"cases": cases, "kernels_alone_ms": alone}


def ring_pairs(i: int, length: int) -> dict:
    """The (q length, kv length, causal) kernel calls of rank ``i`` of
    RANKS in each schedule, causal."""
    lq, c = length // RANKS, length // (2 * RANKS)
    ring = [(lq, lq, True)] + [(lq, lq, False) for r in range(1, RANKS)
                               if i >= r]
    zigzag = [(c, c, True), (c, c, True), (c, c, False)] + \
        [(c, c, False)] * (2 * (RANKS - 1))
    return {"ring": ring, "zigzag": zigzag}


def ring_pair_ms(dev, fa, pairs) -> dict:
    """CUDA-event times (ms) of the forward, dK/dV and dQ kernels (and the
    one pre-pass) over ``pairs`` at 13a's bf16 widths, summed."""
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    out = dict.fromkeys(("flash_fwd", "flash_bwd_prep", "flash_bwd_dkv",
                         "flash_bwd_dq"), 0.0)
    for n, (lq, lk, causal) in enumerate(pairs):
        q, do = (torch.randn((1, RING_HEADS, lq, 64), generator=g, device=dev,
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((1, RING_HEADS, lk, 64), generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        kw = dict(causal=causal, sm_scale=64 ** -0.5)
        o, stat_l, m = fa.flash_attention_fwd(q, k, v, **kw)
        di = fa.flash_bwd_prep(q, k, o, do)[2]
        out["flash_fwd"] += cuda_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                                   **kw))
        if n == 0:
            out["flash_bwd_prep"] += cuda_ms(lambda: fa.flash_bwd_prep(
                q, k, o, do))
        out["flash_bwd_dkv"] += cuda_ms(lambda: fa.flash_bwd_dkv(
            q, k, v, stat_l, m, di, do, **kw))
        out["flash_bwd_dq"] += cuda_ms(lambda: fa.flash_bwd_dq(
            q, k, v, stat_l, m, di, do, **kw))
    out["total"] = sum(out.values())
    return out


def sp_config(kx, schedule: Optional[str]):
    """13b's decoder: the flagship's widths (2048, 32 heads, FFN 8192,
    vocab 32002, multiway), depth cut to SP_LAYERS, bf16 compute, no
    dropout, a positional table for SP_SEQ positions."""
    return kx.MagnetoConfig(
        layers=SP_LAYERS, max_positions=SP_SEQ + 2, compute_dtype="bfloat16",
        dropout=0.0, attention_dropout=0.0, sequence_axis=(
            None if schedule is None else "sequence"),
        sequence_schedule=schedule or "ring")


class _SGD:
    """SGD that keeps the (all-reduced) gradients it was given."""

    def __init__(self, params):
        self.params = params
        self.grads = None

    @torch.no_grad()
    def step(self, grads):
        self.grads = grads
        for n, p in self.params.items():
            if grads.get(n) is not None:
                p.sub_(SP_LR * grads[n])


def _param_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for _, p in sorted(model.named_parameters()):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_sp(dev) -> dict:
    """Phase 13b on one rank: the sequence-parallel step at full width
    (one row of SP_SEQ positions over RANKS ranks, data 1), each schedule
    on a fresh model from the seed; rank 0 then takes one process's step
    on the whole sequence (the flash kernels, xPos fused) and holds both
    ranks' updates against it."""
    import kosmosx_torch as kx
    from kosmosx_torch.nn import decoder as dec
    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.parallel import seq_parallel as sp

    mesh = sp.make_sp_mesh(data=1, sequence=RANKS)
    rank = mesh.get_local_rank("sequence")
    counters = flash_counters(fa)
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    tokens = torch.randint(4, sp_config(kx, None).vocab_size, (1, SP_SEQ),
                           generator=g, device=dev)
    labels, weights = sp.shift_labels(tokens, 1)
    out = {}
    sp_grads = {}
    for schedule in ("ring", "zigzag"):
        cfg = sp_config(kx, schedule)
        model = kx.KosmosLanguage(cfg, generator=torch.Generator(
            device=dev).manual_seed(SEED + 15), device=dev)
        model.set_trainable()
        sgd = _SGD(dict(model.named_parameters()))
        step = sp.make_seq_parallel_train_step(cfg, sgd, mesh)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, tokens, labels, weights)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        out[schedule] = dict(loss=float(loss), step_s=step_s,
                             peak_mem_bytes=torch.cuda.max_memory_allocated(),
                             launches=launches, digest=_param_digest(model))
        sp_grads[schedule] = sgd.grads
        del model, step, sgd
        torch.cuda.empty_cache()
    if rank == 0:
        cfg = sp_config(kx, None)
        model = kx.KosmosLanguage(cfg, generator=torch.Generator(
            device=dev).manual_seed(SEED + 15), device=dev)
        model.set_trainable()
        named = dict(model.named_parameters())
        logits = dec.decoder_forward(model, tokens, cfg).float()
        logz = torch.logsumexp(logits, dim=-1)
        true = torch.take_along_dim(logits, labels[..., None], -1)[..., 0]
        ref_loss = ((logz - true) * weights).sum() / weights.sum()
        grads = torch.autograd.grad(ref_loss, list(named.values()),
                                    allow_unused=True)
        for schedule, got in sp_grads.items():
            errs = {}
            for (n, p), gr in zip(named.items(), grads):
                want = torch.zeros_like(p) if gr is None else gr.float()
                errs[n] = rel_err(got[n], want) if want.abs().max() > 0 \
                    else max_err(got[n], want)
            worst = max(errs, key=errs.get)
            out[schedule].update(
                ref_loss=ref_loss.item(),
                loss_rel_err=abs(out[schedule]["loss"] - ref_loss.item())
                / abs(ref_loss.item()),
                grad_rel_err_max=errs[worst], grad_rel_err_leaf=worst,
                grad_rel_err_median=sorted(errs.values())[len(errs) // 2])
    return out


RANK_TASKS = {"ring": rank_ring, "sp": rank_sp}


def rank_main(task: str) -> int:
    """``chip_smoke.py --rank TASK[,TASK...]``, one rank of phases 13a-13b
    or 14a-14e under torchrun's variables: joins the process group (gloo:
    the ranks share the card), runs the tasks in turn and prints one JSON
    line for each."""
    import torch.distributed as dist

    from kosmosx_torch.ops import _build
    from kosmosx_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    check(initialize_distributed(), "no process group")
    dev = torch.device("cuda", 0)
    tasks = {**RANK_TASKS, "tp_train": rank_tp_train,
             "tp_serve": rank_tp_serve, "ep": rank_ep, "pp": rank_pp,
             "tp_w8": rank_tp_w8}
    for name in task.split(","):
        report = {"rank": dist.get_rank(), "backend": dist.get_backend(),
                  "task": name, **tasks[name](dev)}
        print(json.dumps(report), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_ring(dev) -> dict:
    """Phase 13a: the ring and zigzag ring flash attention in RANKS
    processes on the card; bf16 at RING_SEQ positions against the kernels
    on the whole sequence (phases 3 and 7's bars: 2e-2 on the output, 1e-2
    of each gradient's largest value), fp32 at RING_FP32_SEQ against the
    plain versions (1e-3). Each rank's forward, dK/dV and dQ launches and
    their device time apart from the transport."""
    reports = task_reports("ring")
    log("ring_backend", backend=reports[0]["backend"], ranks=RANKS,
        note="the ranks share one card: gloo, K/V staged through host "
             "memory; the transport time is not the card's links")
    launches = dict.fromkeys(FLASH_KERNELS, 0)
    for rep in reports:
        log("ring_kernels_alone", rank=rep["rank"], seq=RING_SEQ,
            ms=rep["kernels_alone_ms"])
        for key, case in rep["cases"].items():
            bf16 = key.endswith("bfloat16")
            log("ring", rank=rep["rank"], case=key, bar_o=2e-2 if bf16
                else 1e-3, bar_grad_rel=1e-2 if bf16 else 1e-3, **case)
            for n, (abs_e, rel_e) in ((n, (case["max_abs_err"][n],
                                           case["max_rel_err"][n]))
                                      for n in ("o", "dq", "dk", "dv")):
                if n == "o":
                    ok = abs_e < (2e-2 if bf16 else 1e-3)
                else:
                    ok = rel_e < (1e-2 if bf16 else 1e-3)
                check(ok, f"ring rank {rep['rank']} {key} {n}: "
                          f"{abs_e} / {rel_e}")
            for n in ("flash_fwd", "flash_bwd_prep", "flash_bwd_dkv",
                      "flash_bwd_dq"):
                check(case["launches"][n] > 0,
                      f"ring rank {rep['rank']} {key}: no {n} launch")
            check(case["launches"]["flash_bwd_prep"] == 1,
                  f"ring {key}: the pre-pass runs once per ring backward")
            if bf16:
                for n, c in case["launches"].items():
                    launches[n] += c
    return launches


def phase_sp(dev) -> dict:
    """Phase 13b: the sequence-parallel step at full width in RANKS
    processes: the ranks' losses and updated parameters identical, and
    within bf16 bars of one process's step on the whole sequence (loss
    1e-2 relative, each leaf's summed gradient 5e-2 of its largest
    value)."""
    reports = task_reports("sp")
    launches = dict.fromkeys(FLASH_KERNELS, 0)
    for schedule in ("ring", "zigzag"):
        runs = [rep[schedule] for rep in reports]
        log("sp_step", schedule=schedule, seq=SP_SEQ, ranks=RANKS,
            layers=SP_LAYERS, lr=SP_LR,
            per_rank=[{k: v for k, v in r.items() if k != "digest"}
                      for r in runs])
        check(len({r["loss"] for r in runs}) == 1,
              f"sp {schedule}: the ranks' losses differ")
        check(len({r["digest"] for r in runs}) == 1,
              f"sp {schedule}: the ranks' parameters differ")
        ref = runs[0]
        check(ref["loss_rel_err"] < 1e-2,
              f"sp {schedule}: loss {ref['loss']} vs {ref['ref_loss']}")
        check(ref["grad_rel_err_max"] < 5e-2,
              f"sp {schedule}: gradient of {ref['grad_rel_err_leaf']} off by "
              f"{ref['grad_rel_err_max']}")
        for r in runs:
            for n in ("flash_fwd", "flash_bwd_prep", "flash_bwd_dkv",
                      "flash_bwd_dq"):
                check(r["launches"][n] > 0, f"sp {schedule}: no {n} launch")
                launches[n] += r["launches"][n]
            check(r["launches"]["flash_fwd_prep"] == 0,
                  f"sp {schedule}: xPos runs outside the kernels")
    return launches


def phase_cli_distributed(dev) -> None:
    """Phase 13c: the training CLI at full width, ``--distributed --data
    2 --layers 2`` in RANKS processes under torchrun's variables: exit 0
    on both, the same logged losses, rank 0 alone writing the checkpoint
    and the metrics."""
    work = Path(tempfile.mkdtemp(prefix="kx_cli_dist_"))
    try:
        out = work / "out"
        metrics = work / "m.jsonl"
        argv = [sys.executable, "-m", "kosmosx_torch.scripts.train",
                "--distributed", "--data", str(RANKS), "--layers", "2",
                "--model", "language", "--synthetic", "--batch-size", "1",
                "--steps", "2", "--log-every", "1", "--checkpoint-every", "2",
                "--no-final-save", "--device", "cuda", "--output-dir",
                str(out), "--metrics-jsonl", str(metrics)] + CLI_SEQ
        t0 = time.perf_counter()
        outs = run_ranks(argv)
        finals = []
        for rank, (rc, stdout, stderr) in enumerate(outs):
            check(rc == 0, f"--distributed rank {rank}: rc {rc} "
                           f"{stderr[-2000:]}")
            finals.append([ln for ln in stdout.splitlines()
                           if ln.startswith("final:")])
        records = jsonl_records(metrics)
        saved = sorted(p.name for p in out.iterdir())
        log("cli_distributed", seconds=time.perf_counter() - t0,
            final=finals, records=len(records), saved=saved,
            losses=[r.get("loss") for r in records])
        check(finals[0] and finals[0] == finals[1],
              f"--distributed: the ranks' losses differ: {finals}")
        check(saved == ["step_2"], f"--distributed saved {saved}")
        check([r["step"] for r in records] == [1, 2],
              f"--distributed: {len(records)} metrics records (rank 0 "
              f"alone writes them)")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phases 14a-14d: tensor, expert and pipeline parallelism across processes
# ---------------------------------------------------------------------------

PAR_SEQ = 2048            # 14a, 14c, 14d: positions a row
TP_STEPS = 3              # 14a: step 1 held against one process, 2-3 timed
PAR_LR = 1e-3             # 14d: SGD
PP_MICRO = 4              # 14d: microbatches of 1 x PAR_SEQ
PP_STEPS = 2              # 14d: step 1 held against one process, both timed
SERVE_TP_REQUESTS = 16    # 14b: 6i's count, all text
SERVE_TP_LAYERS = 8       # 14b: full width, depth cut
LOSS_BAR = 1e-2           # relative, against one process (13b's bars)
GRAD_BAR = 5e-2           # of each gradient's largest value
LOGIT_BAR = 5e-2          # 14b/14c bf16 logits, of the largest value
EP_AUX_BAR = 1e-3         # 14c: routing loss, relative (read: 0)
# the leaves whose whole gradients are held against one process
TP_SAMPLE = ("layers.0.attn.q.A.w", "layers.0.attn.out.A.w",
             "layers.0.attn.inner_ln.A.scale", "layers.0.ffn.A.fc1.w",
             "layers.0.ffn.A.ffn_ln.scale", "layers.0.ffn.A.fc2.w",
             "layers.23.attn.k.A.w", "layers.23.ffn.A.fc2.w", "embed.table",
             "out_proj.w", "ln.A.scale")
EP_SAMPLE = ("layers.0.ffn.router.w", "layers.0.ffn.experts.fc1.w",
             "layers.0.ffn.experts.fc2.b", "layers.3.ffn.experts.fc2.w",
             "layers.3.attn.v.w", "embed.table")
PP_SAMPLE = ("layers.0.attn.q.A.w", "layers.11.ffn.A.fc2.w",
             "layers.12.attn.out.A.w", "layers.23.ffn.A.fc1.w", "embed.table",
             "out_proj.w", "ln.A.scale")


def par_config(kx, **kw):
    """14a/14b/14d's decoder: the flagship's widths (2048, 32 heads, FFN
    8192, vocab 32002, multiway) at full depth (14b cuts it), bf16
    compute, dropout off, a positional table for PAR_SEQ positions."""
    return kx.MagnetoConfig(**{**dict(
        compute_dtype="bfloat16", dropout=0.0, attention_dropout=0.0,
        max_positions=PAR_SEQ + 2), **kw})


def grad_errors(got: dict, want: dict) -> dict:
    """Each sampled leaf's gradient error relative to its largest value."""
    return {n: rel_err(got[n], want[n]) if want[n].abs().max() > 0
            else max_err(got[n], want[n]) for n in want}


def whole_sample(model, grads: dict, names) -> dict:
    """The whole gradients of ``names`` from this rank's pieces of them (a
    collective over the cuts' groups)."""
    from kosmosx_torch.parallel import sharding as sh

    shards = sh.param_shards(model, set(names))
    return {n: sh.whole(grads[n].float(), shards[n]) for n in names}


def stage_sample(grads: dict, names, shapes: dict, group, dev) -> dict:
    """The gradients of ``names`` on every stage: a layer leaf from the
    stage that holds it (the others add zeros), a replicated one as this
    stage has it."""
    from kosmosx_torch.parallel.comm import all_reduce

    staged = [n for n in names if n.startswith("layers.")]
    summed = all_reduce([grads[n].float() if n in grads else
                         torch.zeros(shapes[n], device=dev)
                         for n in staged], group)
    return {**{n: grads[n].float() for n in names if n not in staged},
            **dict(zip(staged, summed))}


def one_process_grads(model, loss_fn, batch, names) -> tuple:
    """(the logged loss, metrics, {name: gradient}, global norm) of
    ``loss_fn`` on the whole ``model``, as one process's step computes
    them."""
    from kosmosx_torch.train.optim import global_norm
    from kosmosx_torch.train.trainer import value_and_grad

    (_, metrics), grads = value_and_grad(loss_fn, model, batch)
    norm = float(global_norm(grads))
    metrics = {k: float(v) for k, v in metrics.items()}
    return metrics["loss"], metrics, {n: grads[n].float() for n in names}, \
        norm


class _CaptureSGD:
    """SGD (PAR_LR) that keeps the gradients of some leaves it was
    given."""

    def __init__(self, params, names):
        self.params, self.names, self.grads = params, names, {}

    @torch.no_grad()
    def step(self, grads):
        if not self.grads:   # the first step's
            self.grads = {n: grads[n].detach().clone() for n in self.names
                          if n in grads}
        for n, p in self.params.items():
            p.sub_(PAR_LR * grads[n])


def _capture(trainer, names):
    """Wrap ``trainer``'s optimizer: the first step's whole gradients of
    ``names`` and its norm land in the returned dict."""
    seen = {}
    real = trainer.optimizer.step

    def step(grads):
        norm = real(grads)
        if not seen:
            model = trainer.state["params"]
            seen.update(whole_sample(model, grads, names))
            seen["_norm"] = float(norm)
        return norm

    trainer.optimizer.step = step
    return seen


def _train_run(fa, trainer, batch, steps: int) -> dict:
    """``trainer.run`` over ``batch`` repeated: losses, metrics, step
    times, peak memory, flash launches per step, the rank's state bytes."""
    logs, stamps = [], []

    def log_fn(step, m):
        stamps.append(time.perf_counter())
        logs.append(m)

    counters = flash_counters(fa)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer.run(itertools.repeat(batch, steps), log_fn=log_fn)
    launches = {n: fn.launches for n, fn in counters.items()}
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    # a LoraTrainer's state holds the factors; its parameters are the base
    model = trainer.state["params"] if "params" in trainer.state \
        else trainer.base_params
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    return dict(losses=[m["loss"] for m in logs],
                moe_aux=[m.get("moe_aux") for m in logs],
                grad_norms=[m["grad_norm"] for m in logs], step_s=step_s,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                param_bytes=param_bytes,
                moment_bytes=trainer.optimizer.moment_bytes(),
                launches_per_step={k: v / steps for k, v in launches.items()})


def rank_tp_train(dev) -> dict:
    """Phase 14a on one rank: ``Trainer`` over tensor=RANKS on the
    flagship decoder at full width and depth (16 heads a rank), phase 9's
    recipe (bf16 compute, fp32 parameters, Lion, remat "dots", flash) at 2
    x PAR_SEQ; rank 0 then takes one process's step 1 on the whole
    model."""
    import torch.distributed as dist

    import kosmosx_torch as kx
    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.parallel.mesh import make_mesh
    from kosmosx_torch.train.data import synthetic_text_batches
    from kosmosx_torch.train.trainer import TrainConfig, Trainer, lm_loss_fn

    cfg = par_config(kx, remat=True, remat_policy="dots")
    tcfg = TrainConfig(batch_size=2, seq_len=PAR_SEQ, learning_rate=1e-4,
                       optimizer="lion", schedule="constant", warmup_steps=1,
                       total_steps=TP_STEPS, checkpoint_every=0, log_every=1,
                       seed=SEED + 60, prefetch=False)

    def init(g):
        return kx.KosmosLanguage(cfg, generator=g, device=dev)

    batch = next(synthetic_text_batches(batch_size=2, seq_len=PAR_SEQ,
                                        vocab_size=cfg.vocab_size, seed=SEED))
    trainer = Trainer(init, lm_loss_fn(cfg), tcfg, mesh=make_mesh(
        data=1, tensor=RANKS), device=dev)
    trainer.init_state()
    model = trainer.state["params"]
    seen = _capture(trainer, TP_SAMPLE)
    out = _train_run(fa, trainer, batch, TP_STEPS)
    local = {n: list(p.shape) for n, p in model.named_parameters()
             if n in TP_SAMPLE}
    out.update(local_shapes=local, heads_local=cfg.heads // RANKS)
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if dist.get_rank() == 0:
        ref = init(torch.Generator(device=dev).manual_seed(tcfg.seed))
        dev_batch = {k: torch.as_tensor(v, device=dev) for k, v in
                     batch.items()}
        loss, _, grads, norm = one_process_grads(ref, lm_loss_fn(cfg),
                                                 dev_batch, TP_SAMPLE)
        errs = grad_errors({n: seen[n] for n in TP_SAMPLE}, grads)
        out.update(ref_loss=loss, ref_grad_norm=norm,
                   loss_rel_err=abs(out["losses"][0] - loss) / abs(loss),
                   grad_norm_rel_err=abs(seen["_norm"] - norm) / norm,
                   grad_rel_err=errs)
        del ref, grads
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_tp_work(vocab: int) -> list:
    """14b's requests: SERVE_TP_REQUESTS text prompts of 6i's lengths and
    budgets (the seed's draws), 8 at once and the rest as slots free."""
    g = torch.Generator().manual_seed(SEED + 20)
    lo, hi = ENGINE_TEXT_LENGTHS
    lengths = torch.randint(lo, hi + 1, (SERVE_TP_REQUESTS,),
                            generator=g).tolist()
    budgets = torch.randint(32, 65, (SERVE_TP_REQUESTS,), generator=g).tolist()
    texts = [torch.randint(4, vocab, (n,), generator=g).tolist()
             for n in lengths]
    return [dict(prompt=t, max_new_tokens=b, **({"at": 0} if i < 8 else {}))
            for i, (t, b) in enumerate(zip(texts, budgets))]


def first_decode_logits(model, cfg, prompt, dev):
    """The logits of a decode step after a prefill of ``prompt`` (the
    engine's programs, ``generate/sampler.py``), on the model's heads,
    fed the prompt's first token: random weights give near-tied logits,
    so each side's own argmax could feed the two different tokens."""
    from kosmosx_torch.generate import sampler
    from kosmosx_torch.nn import decoder as dec

    with torch.inference_mode():
        tok = torch.tensor([prompt], device=dev)
        lengths = torch.tensor([len(prompt)], device=dev)
        caches = dec.init_cache(cfg, 1, len(prompt) + 1, device=dev,
                                params=model)
        x, _ = dec.forward_embedding(model, cfg, tok)
        sampler._prefill(model, cfg, x, caches, lengths)
        return sampler._decode_logits(model, cfg, tok[:, :1], caches,
                                      lengths)[0, 0].float()


def rank_tp_serve(dev) -> dict:
    """Phase 14b on one rank: ``ServeEngine(mesh=)`` at tensor=RANKS on the
    bf16 flagship decoder (full width, SERVE_TP_LAYERS layers, the decode
    kernel on, 6i's engine settings) over SERVE_TP_REQUESTS text requests; the first decode
    step's logits; then a 2-layer fp32 copy's greedy tokens. Rank 0 then
    takes both on one process."""
    import torch.distributed as dist

    import kosmosx_torch as kx
    from kosmosx_torch.generate.sampler import SamplingConfig
    from kosmosx_torch.ops import decode_attention as da
    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.parallel.mesh import make_mesh
    from kosmosx_torch.serve import ServeConfig, ServeEngine

    mesh = make_mesh(data=1, tensor=RANKS)
    scfg = ServeConfig(max_batch=8, max_prompt_len=512, max_len=1024,
                       sync_lag=4)
    cfg = par_config(kx, decode_attn_kernel=True, max_positions=2048,
                     layers=SERVE_TP_LAYERS)

    def build(c, seed, dtype):
        return kx.KosmosLanguage(c, generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev).to(dtype)

    work = serve_tp_work(cfg.vocab_size)
    out = {}
    for name, c, seed, dtype, reqs in (
            ("bf16", cfg, SEED + 61, torch.bfloat16, work),
            ("fp32", dataclasses.replace(cfg, layers=2,
                                         compute_dtype="float32"),
             SEED + 62, torch.float32,
             [dict(w, max_new_tokens=EXACT_NEW) for w in work[:8]])):
        model = build(c, seed, dtype)
        eng = ServeEngine(model, c, scfg, SamplingConfig(greedy=True),
                          device=dev, mesh=mesh)
        gc.collect()
        torch.cuda.synchronize()
        eng.reset_counters()
        fa.flash_attention.launches = da.decode_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = drive_engine(eng, [dict(w) for w in reqs])
        launches = {"flash": fa.flash_attention.launches,
                    "decode": da.decode_attention.launches}
        handles = res.pop("handles")
        res.pop("ttft_s")
        out[name] = dict(res, tokens=[list(h.tokens) for h in handles],
                         pool_bytes=cache_bytes(eng.caches),
                         pool_heads=int(eng.caches[0]["k"].shape[1]),
                         peak_mem_bytes=torch.cuda.max_memory_allocated(),
                         **engine_launch_checks(
                             eng, res.pop("prefill_widths"), launches,
                             c.layers))
        if name == "bf16":
            out[name]["first_logits"] = first_decode_logits(
                model, c, reqs[0]["prompt"], dev)
        del eng, model
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    logits = out["bf16"].pop("first_logits")
    if dist.get_rank() == 0:
        ref = build(cfg, SEED + 61, torch.bfloat16)
        want = first_decode_logits(ref, cfg, work[0]["prompt"], dev)
        out["bf16"].update(logits_max_abs_err=max_err(logits, want),
                           logits_rel_err=rel_err(logits, want))
        del ref
        c32 = dataclasses.replace(cfg, layers=2, compute_dtype="float32")
        ref = build(c32, SEED + 62, torch.float32)
        eng = ServeEngine(ref, c32, scfg, SamplingConfig(greedy=True),
                          device=dev)
        reqs = [dict(w, max_new_tokens=EXACT_NEW) for w in work[:8]]
        one = [list(h.tokens) for h in drive_engine(eng, reqs)["handles"]]
        from kosmosx_torch.nn.decoder import decoder_forward

        def ref_logits(r, j):
            with torch.inference_mode():
                toks = torch.tensor([reqs[r]["prompt"] + one[r][:j]],
                                    device=dev)
                return decoder_forward(ref, toks, c32)[0, -1]

        out["fp32"]["one_process_tokens"] = one
        out["fp32"]["near_ties"] = exact_tokens(
            "tensor-parallel fp32 engine", out["fp32"]["tokens"], one,
            ref_logits)
        del eng, ref
        gc.collect()
        torch.cuda.empty_cache()
    out["bf16"]["pool_bytes_one_process"] = (
        cfg.layers * 2 * scfg.max_batch * cfg.heads * scfg.max_len
        * cfg.head_dim * 2)
    return out


def rank_ep(dev) -> dict:
    """Phase 14c on one rank, at expert=RANKS: 11b's MoE forward (E = 4, 2
    a rank) at 4 x 2048 in bf16, and one ``Trainer`` step of its
    4-layer cut (fp32 parameters, Lion, remat "dots", the routing loss) at
    2 x PAR_SEQ; rank 0 then takes both on one process."""
    import torch.distributed as dist

    import kosmosx_torch as kx
    from kosmosx_torch.nn.decoder import decoder_forward
    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.parallel.mesh import make_mesh
    from kosmosx_torch.parallel.sharding import shard_params
    from kosmosx_torch.train.data import synthetic_text_batches
    from kosmosx_torch.train.trainer import TrainConfig, Trainer, lm_loss_fn

    mesh = make_mesh(data=1, expert=RANKS)
    model, cfg = moe_model(dev, kx, SEED + 31)
    shard_params(model, mesh)
    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    tokens = torch.randint(4, cfg.vocab_size, (MOE_BATCH, MOE_SEQ),
                           generator=g, device=dev)
    fwd = decoder_forward_reading(model, cfg, tokens, fa)
    with torch.inference_mode():
        logits, aux = decoder_forward(model, tokens, cfg, with_aux=True)
    experts = {n: list(p.shape) for n, p in model.named_parameters()
               if n.startswith("layers.0.ffn.experts")}
    expert_bytes = sum(p.numel() * p.element_size() for n, p in
                       model.named_parameters() if ".experts." in n)
    out = dict(forward=fwd, aux=float(aux), expert_shapes=experts,
               expert_bytes=expert_bytes)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    tcfg_m = moe_config(kx, layers=4, remat=True, remat_policy="dots")
    tcfg = TrainConfig(batch_size=2, seq_len=PAR_SEQ, learning_rate=1e-4,
                       optimizer="lion", schedule="constant", warmup_steps=1,
                       total_steps=2, checkpoint_every=0, log_every=1,
                       seed=SEED + 65, prefetch=False)

    def init(gen):
        return kx.KosmosLanguage(tcfg_m, generator=gen, device=dev)

    batch = next(synthetic_text_batches(batch_size=2, seq_len=PAR_SEQ,
                                        vocab_size=cfg.vocab_size, seed=SEED))
    trainer = Trainer(init, lm_loss_fn(tcfg_m), tcfg, mesh=mesh, device=dev)
    trainer.init_state()
    seen = _capture(trainer, EP_SAMPLE)
    out["train"] = _train_run(fa, trainer, batch, 2)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if dist.get_rank() == 0:
        ref = moe_model(dev, kx, SEED + 31)[0]
        with torch.inference_mode():
            want, want_aux = decoder_forward(ref, tokens, cfg, with_aux=True)
        out.update(logits_max_abs_err=max_err(logits, want),
                   logits_rel_err=rel_err(logits, want),
                   aux_rel_err=abs(float(aux) - float(want_aux))
                   / abs(float(want_aux)))
        del ref, want
        gc.collect()
        torch.cuda.empty_cache()
        ref = init(torch.Generator(device=dev).manual_seed(tcfg.seed))
        dev_batch = {k: torch.as_tensor(v, device=dev) for k, v in
                     batch.items()}
        loss, metrics, grads, norm = one_process_grads(
            ref, lm_loss_fn(tcfg_m), dev_batch, EP_SAMPLE)
        tr = out["train"]
        tr.update(ref_loss=loss, ref_moe_aux=metrics["moe_aux"],
                  ref_grad_norm=norm,
                  loss_rel_err=abs(tr["losses"][0] - loss) / abs(loss),
                  moe_aux_rel_err=abs(tr["moe_aux"][0] - metrics["moe_aux"])
                  / abs(metrics["moe_aux"]),
                  grad_norm_rel_err=abs(seen["_norm"] - norm) / norm,
                  grad_rel_err=grad_errors(
                      {n: seen[n] for n in EP_SAMPLE}, grads))
        del ref, grads
        gc.collect()
        torch.cuda.empty_cache()
    del logits
    return out


def rank_pp(dev) -> dict:
    """Phase 14d on one rank: PP_STEPS GPipe and 1F1B SGD steps at pipe=RANKS
    on the flagship decoder at full width and depth (12 layers a stage), M
    = PP_MICRO microbatches of 1 x PAR_SEQ, bf16 compute; rank 0 then takes
    one process's loss and gradients (step 1's); launches are per step."""
    import torch.distributed as dist

    import kosmosx_torch as kx
    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.parallel import pipeline as pp
    from kosmosx_torch.parallel.seq_parallel import shift_labels

    mesh = pp.make_pp_mesh(data=1, pipe=RANKS)
    cfg = par_config(kx, scan_layers=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 64)
    tokens = torch.randint(4, cfg.vocab_size, (PP_MICRO, PAR_SEQ),
                           generator=g, device=dev)
    labels, weights = shift_labels(tokens, cfg.padding_idx)

    def build():
        m = kx.KosmosLanguage(cfg, generator=torch.Generator(
            device=dev).manual_seed(SEED + 63), device=dev)
        m.set_trainable()
        return m

    d, f = cfg.embed_dim, cfg.ffn_dim
    shapes = {"layers.0.attn.q.A.w": (d, d), "layers.11.ffn.A.fc2.w": (f, d),
              "layers.12.attn.out.A.w": (d, d),
              "layers.23.ffn.A.fc1.w": (d, f)}
    counters = flash_counters(fa)
    out = {}
    for kind, make in (("gpipe", pp.make_pipeline_train_step),
                       ("1f1b", pp.make_pipeline_train_step_1f1b)):
        model = pp.pipeline_stage(build(), mesh)
        sgd = _CaptureSGD(dict(model.named_parameters()), PP_SAMPLE)
        step = make(cfg, sgd, mesh, microbatches=PP_MICRO)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for fn in counters.values():
            fn.launches = 0
        losses, step_s = [], []
        for _ in range(PP_STEPS):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(model, tokens, labels, weights)))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        out[kind] = dict(
            loss=losses[0], losses=losses, step_s=step_s,
            ticks=step.num_ticks,
            stash_slots=getattr(step, "stash_slots", None),
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            state_bytes=base,
            step_peak_over_state_bytes=torch.cuda.max_memory_allocated()
            - base,
            layers=sorted(int(n.split(".")[1]) for n, _ in
                          model.named_parameters()
                          if n.startswith("layers.") and n.endswith(
                              "attn.q.A.w")),
            launches={n: fn.launches // PP_STEPS
                      for n, fn in counters.items()})
        out[kind]["_grads"] = stage_sample(sgd.grads, PP_SAMPLE, shapes,
                                           mesh.get_group("pipe"), dev)
        del model, sgd, step
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    grads_by_kind = {k: out[k].pop("_grads") for k in out}
    if dist.get_rank() == 0:
        ref = build()
        named = dict(ref.named_parameters())
        from kosmosx_torch.nn.decoder import decoder_forward

        logits = decoder_forward(ref, tokens, cfg).float()
        logz = torch.logsumexp(logits, dim=-1)
        true = torch.take_along_dim(logits, labels[..., None], -1)[..., 0]
        ref_loss = ((logz - true) * weights).sum() / weights.sum()
        del logits, logz
        got = torch.autograd.grad(ref_loss, [named[n] for n in PP_SAMPLE])
        want = {n: gr.float() for n, gr in zip(PP_SAMPLE, got)}
        for kind, grads in grads_by_kind.items():
            out[kind].update(
                ref_loss=ref_loss.item(),
                loss_rel_err=abs(out[kind]["loss"] - ref_loss.item())
                / abs(ref_loss.item()),
                grad_rel_err=grad_errors(grads, want))
        del ref, named, want, got
        gc.collect()
        torch.cuda.empty_cache()
    return out


TP_W8_LORA_RANK = 16      # 14e: the adapters' rank
TP_QLORA_LAYERS = 4       # 14e: QLoRA's depth cut
TP_QLORA_STEPS = 2
# the per-rank cut of each W8 stack of the flagship at tensor=2 (layer 0's
# markers), and the factors whose step-1 gradients 14e holds
TP_W8_CUTS = {"attn.q.A.w": (24, 2048, 1024), "attn.k.A.w": (24, 2048, 1024),
              "attn.v.A.w": (24, 2048, 1024), "attn.out.A.w": (24, 1024, 2048),
              "ffn.A.fc1.w": (24, 2048, 4096), "ffn.A.fc2.w": (24, 4096, 2048)}
TP_QLORA_SAMPLE = ("layers.0.attn.q.A.lora.b", "layers.0.attn.out.A.lora.b",
                   "layers.0.attn.out.A.lora.a", "layers.3.ffn.A.fc1.lora.b",
                   "layers.3.ffn.A.fc2.lora.b")
W8_COUNTS = (("stacked", "w8_matmul_stacked", "launches"),
             ("stacked_hopper", "w8_matmul_stacked", "hopper_launches"),
             ("head", "w8_matmul", "launches"),
             ("head_hopper", "w8_matmul", "hopper_launches"))


def tp_w8_flagship(dev, kx):
    """6k's W8 model: the bf16 flagship Kosmos from phase 5's seed, the
    decode kernel on, quantized in the stacked layout (``w8_model``)."""
    from kosmosx_torch.models.kosmos import Kosmos

    cfg = flagship_config(kx)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, decode_attn_kernel=True))
    model = Kosmos(cfg, generator=torch.Generator(device=dev).manual_seed(
        SEED + 2), device=dev).to(torch.bfloat16)
    w8, scan = w8_model(model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return w8, scan


def tp_adapters(dev, base) -> dict:
    """14e's two adapters of rank TP_W8_LORA_RANK on the whole ``base``:
    ``a`` from ``add_lora``, ``b`` random (6j's draw), seeded alike on
    every rank."""
    from kosmosx_torch.train import lora

    trees = {}
    for name, seed in (("A", 71), ("B", 72)):
        gl = torch.Generator(device=dev).manual_seed(SEED + seed)
        tree = lora.strip_lora(lora.add_lora(gl, base, TP_W8_LORA_RANK))[1]

        def rand_b(node):
            if isinstance(node, dict):
                if "b" in node and "a" in node:
                    node["b"] = torch.randn(node["b"].shape, generator=gl,
                                            device=dev) * 0.05
                for v in node.values():
                    rand_b(v)
            elif isinstance(node, list):
                for v in node:
                    rand_b(v)
        rand_b(tree)
        trees[name] = tree
    return trees


def tp_qlora_setup(dev, kx):
    """14e's QLoRA: a TP_QLORA_LAYERS-layer W8 cut of the flagship decoder
    (stacked codes, bf16 compute), its ``TrainConfig`` (AdamW, constant lr
    after a 1-step warmup) and batch (2 x PAR_SEQ): (cfg, base, tcfg,
    batch)."""
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.train.data import synthetic_text_batches
    from kosmosx_torch.train.trainer import TrainConfig
    from kosmosx_torch.utils.quantize import quantize_params_w8

    cfg = par_config(kx, layers=TP_QLORA_LAYERS, scan_layers=True)
    base = quantize_params_w8(KosmosLanguage(cfg, generator=torch.Generator(
        device=dev).manual_seed(SEED + 64), device=dev))
    tcfg = TrainConfig(batch_size=2, seq_len=PAR_SEQ, learning_rate=LORA_LR,
                       optimizer="adamw", schedule="constant", warmup_steps=1,
                       total_steps=TP_QLORA_STEPS, checkpoint_every=0,
                       log_every=1, seed=SEED + 65, prefetch=False)
    batch = next(synthetic_text_batches(batch_size=2, seq_len=PAR_SEQ,
                                        vocab_size=cfg.vocab_size, seed=SEED))
    return cfg, base, tcfg, batch


def tp_qlora(dev, kx, mesh) -> tuple:
    """Two QLoRA ``LoraTrainer`` steps over ``mesh`` on 14e's setup: (the
    run's readings, step 1's loss, its gradients of TP_QLORA_SAMPLE)."""
    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.ops import quant_matmul as qm
    from kosmosx_torch.train.lora import LoraTrainer
    from kosmosx_torch.train.trainer import lm_loss_fn

    cfg, base, tcfg, batch = tp_qlora_setup(dev, kx)
    trainer = LoraTrainer(None, lm_loss_fn(cfg), tcfg, LORA_RANK, mesh=mesh,
                          base_params=base, device=dev)
    trainer.init_state()
    seen = {}
    real = trainer.optimizer.step

    def step(grads):
        if not seen:
            seen.update({n: grads[n].float().clone()
                         for n in TP_QLORA_SAMPLE})
        return real(grads)

    trainer.optimizer.step = step
    for fn in (qm.w8_matmul, qm.w8_matmul_stacked):
        fn.launches = fn.hopper_launches = 0
    out = _train_run(fa, trainer, batch, TP_QLORA_STEPS)
    out["w8_launches_per_step"] = {
        key: getattr(getattr(qm, fn), attr) / TP_QLORA_STEPS
        for key, fn, attr in W8_COUNTS}
    del trainer, base
    gc.collect()
    torch.cuda.empty_cache()
    return out, out["losses"][0], seen


def tp_qlora_reference(dev, kx) -> tuple:
    """One process's step 1 of ``tp_qlora``: the factors ``LoraTrainer``
    draws (its seeded generator, on the whole base), the loss and the
    factors' gradients, outside a ``Trainer`` (which would join the
    ranks' group): (loss, gradients of TP_QLORA_SAMPLE)."""
    from kosmosx_torch.train import lora
    from kosmosx_torch.train.data import to_device
    from kosmosx_torch.train.trainer import lm_loss_fn

    cfg, base, tcfg, batch = tp_qlora_setup(dev, kx)
    base.requires_grad_(False)
    rng = torch.Generator(device=dev).manual_seed(tcfg.seed)
    tree = lora.strip_lora(lora.add_lora(rng, base, LORA_RANK))[1]
    state = lora.lora_state(tree, lambda named: None, rng)
    model = lora.adapted_module(base, state["lora"])
    leaves = lora.lora_state_dict(state["lora"])
    loss, metrics = lm_loss_fn(cfg)(model, to_device(batch, dev), None)
    grads = torch.autograd.grad(loss, [leaves[n] for n in TP_QLORA_SAMPLE])
    out = float(metrics["loss"]), {n: g.float() for n, g in
                                   zip(TP_QLORA_SAMPLE, grads)}
    del model, base
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rank_tp_w8(dev) -> dict:
    """Phase 14e on one rank, at tensor=RANKS: the W8 flagship engine over
    6k's requests (each rank's cut stacks and their kernel by the shape
    rule, launches per decode dispatch, the first decode step's logits),
    two adapters on a 2-layer fp32 copy, two QLoRA steps; rank 0 then
    takes the one-process references."""
    import torch.distributed as dist

    import kosmosx_torch as kx
    from kosmosx_torch.generate.sampler import SamplingConfig
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.nn.decoder import decoder_forward
    from kosmosx_torch.ops import decode_attention as da
    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.ops import quant_matmul as qm
    from kosmosx_torch.parallel.mesh import make_mesh
    from kosmosx_torch.serve import ServeConfig, ServeEngine
    from kosmosx_torch.train import lora
    from kosmosx_torch.utils.quantize import w8_param_bytes

    mesh = make_mesh(data=1, tensor=RANKS)
    rank0 = dist.get_rank() == 0
    scfg = ServeConfig(max_batch=8, max_prompt_len=512, max_len=1024,
                       sync_lag=4)
    out = {}

    # 1. the W8 flagship engine
    w8, wcfg = tp_w8_flagship(dev, kx)
    work = w8_engine_work(wcfg.decoder.vocab_size)
    eng = ServeEngine(w8, wcfg.decoder, scfg, SamplingConfig(greedy=True),
                      kosmos_cfg=wcfg, device=dev, mesh=mesh)
    layer0 = w8["decoder"]["layers"][0]
    cuts = {}
    for name in TP_W8_CUTS:
        q = layer0.get_submodule(name)._parameters["q"]
        x = torch.zeros(8, q.shape[-2], dtype=torch.bfloat16, device=dev)
        cuts[name] = dict(shape=list(q.shape),
                          path=_w8_path(qm, x, q))
    counts = []

    def on_step(e, handles, step):
        counts.append([e.steps, e.prefills] + [
            getattr(getattr(qm, fn), attr) for _, fn, attr in W8_COUNTS])

    gc.collect()
    torch.cuda.synchronize()
    eng.reset_counters()
    for fn in (qm.w8_matmul, qm.w8_matmul_stacked):
        fn.launches = fn.hopper_launches = 0
    fa.flash_attention.launches = da.decode_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with vocab_head_paths(qm, wcfg) as vocab_paths:
        res = drive_engine(eng, [dict(w) for w in work], on_step)
    # every step after the last admission prefill only decodes
    first = next(c for c in counts if c[1] == counts[-1][1])
    dispatches = counts[-1][0] - first[0]
    per_dispatch = {key: (counts[-1][2 + i] - first[2 + i]) / dispatches
                    for i, (key, _, _) in enumerate(W8_COUNTS)}
    handles = res.pop("handles")
    res.pop("ttft_s")
    out["w8"] = dict(
        res, tokens=[list(h.tokens) for h in handles], cuts=cuts,
        per_dispatch=per_dispatch, measured_dispatches=dispatches,
        w8_launches={key: getattr(getattr(qm, fn), attr)
                     for key, fn, attr in W8_COUNTS},
        vocab_head_paths=dict(vocab_paths),
        decode_launches=da.decode_attention.launches,
        flash_launches=fa.flash_attention.launches,
        pool_heads=int(eng.caches[0]["k"].shape[1]),
        w8_bytes=w8_param_bytes(w8),
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        **engine_launch_checks(eng, res.pop("prefill_widths"),
                               {"decode": da.decode_attention.launches,
                                "flash": fa.flash_attention.launches},
                               wcfg.decoder.layers))
    logits = first_decode_logits(w8["decoder"], wcfg.decoder,
                                 work[0]["prompt"], dev)
    del eng, w8
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank0:
        ref, _ = tp_w8_flagship(dev, kx)
        out["w8"]["w8_bytes_one_process"] = w8_param_bytes(ref)
        want = first_decode_logits(ref["decoder"], wcfg.decoder,
                                   work[0]["prompt"], dev)
        out["w8"].update(logits_max_abs_err=max_err(logits, want),
                         logits_rel_err=rel_err(logits, want))
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()

    # 2. two adapters on a 2-layer fp32 copy, the decode kernel on
    c32 = par_config(kx, layers=2, compute_dtype="float32",
                     decode_attn_kernel=True, max_positions=2048)

    def base32():
        return KosmosLanguage(c32, generator=torch.Generator(
            device=dev).manual_seed(SEED + 63), device=dev)

    names = ["A", "B"] * 4
    reqs = [dict(w, max_new_tokens=EXACT_NEW, adapter=n)
            for w, n in zip(serve_tp_work(c32.vocab_size)[:8], names)]
    model = base32()
    trees = tp_adapters(dev, model)
    eng = ServeEngine(model, c32, scfg, SamplingConfig(greedy=True),
                      device=dev, mesh=mesh)
    for name, tree in trees.items():
        eng.load_adapter(name, tree)
    res = drive_engine(eng, [dict(r) for r in reqs])
    out["lora"] = dict(tokens=[list(h.tokens) for h in res["handles"]],
                       tok_per_s=res["tok_per_s"], wall_s=res["wall_s"],
                       pool_heads=int(eng.caches[0]["k"].shape[1]))
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank0:
        ref = base32()
        trees = tp_adapters(dev, ref)
        eng = ServeEngine(ref, c32, scfg, SamplingConfig(greedy=True),
                          device=dev)
        for name, tree in trees.items():
            eng.load_adapter(name, tree)
        one = [list(h.tokens) for h in
               drive_engine(eng, [dict(r) for r in reqs])["handles"]]

        def ref_logits(r, j):
            with torch.inference_mode():
                toks = torch.tensor([reqs[r]["prompt"] + one[r][:j]],
                                    device=dev)
                return decoder_forward(
                    lora.attach_lora(ref, trees[names[r]]), toks, c32)[0, -1]

        out["lora"].update(one_process_tokens=one, near_ties=exact_tokens(
            "14e multi-LoRA over tensor", out["lora"]["tokens"], one,
            ref_logits))
        del eng, ref
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()

    # 3. two QLoRA steps
    run, loss, grads = tp_qlora(dev, kx, mesh)
    out["qlora"] = run
    dist.barrier()
    if rank0:
        want_loss, want = tp_qlora_reference(dev, kx)
        errs = grad_errors(grads, want)
        out["qlora"].update(ref_loss=want_loss,
                            loss_rel_err=abs(loss - want_loss)
                            / abs(want_loss), grad_rel_err=errs)
    return out


def tp_w8_kernel_times(dev, qm) -> dict:
    """The W8 kernels alone at a rank's decode shapes under 14e (M = 8
    slots): the stacked kernel over each cut stack (layer 11), the 2-D
    kernel over the whole vocab head, against the plain version, with
    their bounds (ops/roofline.py)."""
    from kosmosx_torch.ops import roofline as rl
    from kosmosx_torch.utils.quantize import _quantize_w

    g = torch.Generator(device=dev).manual_seed(SEED + 73)
    out = {}
    for stack in sorted(set(TP_W8_CUTS.values())):
        w = _quantize_w(torch.randn(stack, generator=g, device=dev) * 0.02)
        x = torch.randn(8, stack[1], generator=g, device=dev).bfloat16()
        layer = torch.tensor(11, dtype=torch.int32, device=dev)
        case = _w8_case(
            "w8_matmul_stacked", qm.w8_matmul_stacked,
            lambda: qm.w8_matmul_stacked(x, w["q"], w["scale"], layer),
            lambda: qm.w8_matmul_plain(x, w["q"][11], w["scale"][11]), 1e-2,
            "hopper", m=8, stack=list(stack), layer=11, dtype="bfloat16",
            tensor_rank_cut=True)
        out[str(list(stack))] = dict(
            case, bound_ms=rl.bound(rl.w8_matmul_work(8, *stack[1:]),
                                    rl.H100_BF16_FLOPS)[0])
        del w
    w = _quantize_w(torch.randn(W8_VOCAB, generator=g, device=dev) * 0.02)
    x = torch.randn(8, W8_VOCAB[0], generator=g, device=dev).bfloat16()
    case = _w8_case("w8_matmul", qm.w8_matmul,
                    lambda: qm.w8_matmul(x, w["q"], w["scale"]),
                    lambda: qm.w8_matmul_plain(x, w["q"], w["scale"]), 1e-2,
                    "hopper", m=8, k=W8_VOCAB[0], n=W8_VOCAB[1],
                    dtype="bfloat16", tensor_rank_cut=False)
    out["vocab_head"] = dict(case, bound_ms=rl.bound(
        rl.w8_matmul_work(8, *W8_VOCAB), rl.H100_BF16_FLOPS)[0])
    return out


def phase_tp_w8(dev, qm) -> dict:
    """Phase 14e: W8 weights and adapters over tensor=RANKS (``--rank
    tp_w8``), then the W8 kernels alone at a rank's shapes. Returns the
    ranks' launches by kernel."""
    reports = task_reports("tp_w8")
    ref = reports[0]
    log("tp_w8", ranks=RANKS, requests=len(ref["w8"]["tokens"]),
        nvidia_smi=nvidia_smi_line(),
        per_rank=[{k: {kk: vv for kk, vv in v.items() if "tokens" not in kk}
                   for k, v in r.items() if isinstance(v, dict)}
                  for r in reports])
    for name in ("w8", "lora"):
        toks = [r[name]["tokens"] for r in reports]
        check(all(t == toks[0] for t in toks),
              f"14e {name}: the ranks' tokens differ")
    work = w8_engine_work(32002)
    check([len(t) for t in ref["w8"]["tokens"]] == [w["max_new_tokens"]
                                                    for w in work],
          "14e: every W8 request served to its budget")
    launches = collections.Counter()
    for r in reports:
        w8 = r["w8"]
        check(all(c["shape"] == list(TP_W8_CUTS[n]) and c["path"] == "hopper"
                  for n, c in w8["cuts"].items()),
              f"14e W8 cuts {w8['cuts']}")
        per = w8["per_dispatch"]
        check(per["stacked"] == per["stacked_hopper"] == 144
              and per["head"] == per["head_hopper"] == 1,
              f"14e W8 launches per decode dispatch {per}")
        check(set(w8["vocab_head_paths"]) == {"hopper"},
              f"14e vocab head paths {w8['vocab_head_paths']}")
        check(w8["launches"] == w8["want"] and w8["pool_heads"] == 32 // RANKS,
              f"14e engine launches {w8['launches']} want {w8['want']}, "
              f"pool heads {w8['pool_heads']}")
        q = r["qlora"]
        wl = q["w8_launches_per_step"]
        check(wl["stacked"] == wl["stacked_hopper"] == 6 * TP_QLORA_LAYERS
              and wl["head"] == wl["head_hopper"] == 1,
              f"14e QLoRA W8 launches per step {wl}")
        fl = q["launches_per_step"]
        check(fl["flash_fwd"] == fl["flash_bwd_dkv"] == fl["flash_bwd_dq"]
              == TP_QLORA_LAYERS, f"14e QLoRA flash launches per step {fl}")
        launches["w8_matmul_stacked"] += (w8["w8_launches"]["stacked"]
                                          + wl["stacked"] * TP_QLORA_STEPS)
        launches["w8_matmul.hopper"] += (w8["w8_launches"]["head_hopper"]
                                         + wl["head_hopper"] * TP_QLORA_STEPS)
        launches["decode_attention"] += w8["decode_launches"]
        launches["flash_fwd"] += w8["flash_launches"]
        for n in FLASH_KERNELS:
            launches[n] += int(fl[n] * TP_QLORA_STEPS)
    check(ref["w8"]["logits_rel_err"] < LOGIT_BAR,
          f"14e first decode logits off by {ref['w8']['logits_rel_err']}")
    q = ref["qlora"]
    check(q["loss_rel_err"] < LOSS_BAR,
          f"14e QLoRA loss {q['losses'][0]} vs {q['ref_loss']}")
    worst = max(q["grad_rel_err"], key=q["grad_rel_err"].get)
    check(q["grad_rel_err"][worst] < GRAD_BAR,
          f"14e QLoRA gradient of {worst} off by {q['grad_rel_err'][worst]}")
    times = tp_w8_kernel_times(dev, qm)
    log("tp_w8_kernels", nvidia_smi=nvidia_smi_line(), **times)
    return dict(launches=dict(launches), times=times)


def phase_tp_train(dev) -> dict:
    """Phase 14a: the tensor-parallel training step in RANKS processes on
    the card: the ranks' losses and gradient norms identical; step 1's loss
    and gradient norm within LOSS_BAR of one process's, each sampled leaf's
    whole gradient within GRAD_BAR; the cut leaves held as halves; the
    flash kernels on 16 heads a rank, the forward twice (remat) and the
    backward's three once per layer and step."""
    reports = task_reports("tp_train")
    ref = reports[0]
    log("tp_train", ranks=RANKS, batch=[2, PAR_SEQ], steps=TP_STEPS,
        nvidia_smi=nvidia_smi_line(), per_rank=reports)
    check(len({tuple(r["losses"]) for r in reports}) == 1,
          f"14a: the ranks' losses differ: {[r['losses'] for r in reports]}")
    check(ref["loss_rel_err"] < LOSS_BAR and
          ref["grad_norm_rel_err"] < LOSS_BAR,
          f"14a: loss {ref['losses'][0]} vs {ref['ref_loss']}, norm "
          f"{ref['grad_norms'][0]} vs {ref['ref_grad_norm']}")
    worst = max(ref["grad_rel_err"], key=ref["grad_rel_err"].get)
    check(ref["grad_rel_err"][worst] < GRAD_BAR,
          f"14a: gradient of {worst} off by {ref['grad_rel_err'][worst]}")
    check(ref["local_shapes"]["layers.0.attn.q.A.w"] == [2048, 2048 // RANKS]
          and ref["local_shapes"]["layers.0.ffn.A.fc2.w"] == [8192 // RANKS,
                                                             2048],
          f"14a: local shapes {ref['local_shapes']}")
    launches = dict.fromkeys(FLASH_KERNELS, 0)
    for r in reports:
        per = r["launches_per_step"]
        check(per["flash_fwd"] == 48 and per["flash_bwd_dkv"] ==
              per["flash_bwd_dq"] == per["flash_bwd_prep"] == 24,
              f"14a rank launches per step {per}")
        for n in FLASH_KERNELS:
            launches[n] += int(per[n] * TP_STEPS)
    return launches


def phase_tp_serve(dev) -> dict:
    """Phase 14b: ``ServeEngine(mesh=)`` at tensor=RANKS: the ranks' tokens
    identical, every request served to its budget, the decode kernel once
    per layer and decode dispatch on each rank, the pool half of one
    process's, the first decode step's bf16 logits within LOGIT_BAR of one
    process's, the fp32 copy's greedy tokens those of the one-process
    engine (or an fp32 near-tie)."""
    reports = task_reports("tp_serve")
    ref = reports[0]
    log("tp_serve", ranks=RANKS, requests=SERVE_TP_REQUESTS,
        nvidia_smi=nvidia_smi_line(),
        per_rank=[{k: {kk: vv for kk, vv in v.items() if "tokens" not in kk}
                   for k, v in r.items() if isinstance(v, dict)}
                  for r in reports])
    launches = 0
    for name in ("bf16", "fp32"):
        toks = [r[name]["tokens"] for r in reports]
        check(all(t == toks[0] for t in toks),
              f"14b {name}: the ranks' tokens differ")
        for r in reports:
            case = r[name]
            check(case["launches"] == case["want"],
                  f"14b {name} launches {case['launches']} want "
                  f"{case['want']}")
            check(case["pool_heads"] == 32 // RANKS,
                  f"14b {name}: pool heads {case['pool_heads']}")
            if name == "bf16":
                launches += case["launches"]["decode"]
    bf = ref["bf16"]
    work = serve_tp_work(32002)
    check([len(t) for t in bf["tokens"]] == [w["max_new_tokens"]
                                             for w in work],
          "14b: every request served to its budget")
    check(bf["pool_bytes"] * RANKS == bf["pool_bytes_one_process"],
          f"14b pool {bf['pool_bytes']} a rank of "
          f"{bf['pool_bytes_one_process']}")
    check(bf["logits_rel_err"] < LOGIT_BAR,
          f"14b first decode logits off by {bf['logits_rel_err']}")
    return {"decode": launches}


def phase_ep(dev) -> dict:
    """Phase 14c: the expert axis at expert=RANKS: 11b's MoE forward's
    logits within LOGIT_BAR of one process's at every position, its
    routing loss within EP_AUX_BAR, two experts a rank; the 4-layer
    training step's loss, routing loss and gradient norm within LOSS_BAR
    of one process's and each sampled leaf's gradient within GRAD_BAR; the
    flash kernels on each rank."""
    reports = task_reports("ep")
    ref = reports[0]
    log("ep", ranks=RANKS, forward_batch=[MOE_BATCH, MOE_SEQ],
        train_batch=[2, PAR_SEQ], nvidia_smi=nvidia_smi_line(),
        per_rank=reports)
    check(all(r["expert_shapes"]["layers.0.ffn.experts.fc1.w"] ==
              [4 // RANKS, 2048, 8192] for r in reports),
          f"14c expert shapes {ref['expert_shapes']}")
    check(len({r["aux"] for r in reports}) == 1 and
          len({tuple(r["train"]["losses"]) for r in reports}) == 1,
          "14c: the ranks disagree")
    check(ref["logits_rel_err"] < LOGIT_BAR
          and ref["aux_rel_err"] < EP_AUX_BAR,
          f"14c forward: logits off by {ref['logits_rel_err']} of the "
          f"largest, routing loss by {ref['aux_rel_err']}")
    tr = ref["train"]
    check(tr["loss_rel_err"] < LOSS_BAR and tr["moe_aux_rel_err"] < LOSS_BAR
          and tr["grad_norm_rel_err"] < LOSS_BAR,
          f"14c train: loss {tr['loss_rel_err']}, aux "
          f"{tr['moe_aux_rel_err']}, norm {tr['grad_norm_rel_err']}")
    worst = max(tr["grad_rel_err"], key=tr["grad_rel_err"].get)
    check(tr["grad_rel_err"][worst] < GRAD_BAR,
          f"14c: gradient of {worst} off by {tr['grad_rel_err'][worst]}")
    launches = dict.fromkeys(FLASH_KERNELS, 0)
    for r in reports:
        check(r["forward"]["flash_launches"] == 24,
              f"14c forward flash launches {r['forward']}")
        per = r["train"]["launches_per_step"]
        check(per["flash_fwd"] == 8 and per["flash_bwd_dkv"] == 4,
              f"14c train launches per step {per}")
        for n in FLASH_KERNELS:
            launches[n] += int(per[n] * 2)
        launches["flash_fwd"] += int(r["forward"]["flash_launches"])
        launches["flash_fwd_prep"] += int(
            r["forward"]["flash_fwd_prep_launches"])
    return launches


def phase_pp(dev) -> dict:
    """Phase 14d: GPipe and 1F1B at pipe=RANKS: the ranks' losses
    identical and within LOSS_BAR of one process's, each sampled leaf's
    gradient (the SGD update over the learning rate) within GRAD_BAR, each
    stage holding its 12 layers, the schedules' ticks, the flash kernels on
    each stage (1F1B's forward twice: its backward recomputes)."""
    reports = task_reports("pp")
    log("pp", ranks=RANKS, microbatches=PP_MICRO, micro_batch=[1, PAR_SEQ],
        nvidia_smi=nvidia_smi_line(), per_rank=reports)
    launches = dict.fromkeys(FLASH_KERNELS, 0)
    for kind, ticks in (("gpipe", PP_MICRO + RANKS - 1),
                        ("1f1b", PP_MICRO + 2 * RANKS - 2)):
        runs = [r[kind] for r in reports]
        check(len({r["loss"] for r in runs}) == 1,
              f"14d {kind}: the ranks' losses differ")
        ref = runs[0]
        check(ref["loss_rel_err"] < LOSS_BAR,
              f"14d {kind}: loss {ref['loss']} vs {ref['ref_loss']}")
        worst = max(ref["grad_rel_err"], key=ref["grad_rel_err"].get)
        check(ref["grad_rel_err"][worst] < GRAD_BAR,
              f"14d {kind}: gradient of {worst} off by "
              f"{ref['grad_rel_err'][worst]}")
        per_stage = 24 // RANKS
        for i, r in enumerate(runs):
            check(r["ticks"] == ticks and r["layers"] == list(
                range(i * per_stage, (i + 1) * per_stage)),
                f"14d {kind} rank {i}: ticks {r['ticks']}, layers "
                f"{r['layers']}")
            # 1F1B's forward ticks run without a graph and its backward
            # ticks recompute; the last stage's forward ticks run nothing
            twice = kind == "1f1b" and i < RANKS - 1
            fwd = per_stage * PP_MICRO * (2 if twice else 1)
            check(r["launches"]["flash_fwd"] == fwd and
                  r["launches"]["flash_bwd_dkv"] == per_stage * PP_MICRO,
                  f"14d {kind} rank {i} launches {r['launches']}")
            for n in FLASH_KERNELS:
                launches[n] += r["launches"][n]
    return launches


def kernels_line(flash, decode, bwd, w8k, w8_lib, tile, launches) -> list:
    """One entry per kernel: its launches in its slice's main-path run
    (``launches``, by kernel name), its largest bf16 error against the plain
    version, and at its main-path shape its time, the plain version's, its
    bound (ops/roofline.py, from these inputs' shapes) and its library
    yardstick's time (None where there is none). Where ``ms`` is a CUDA-graph
    device time (decode, W8), ``launch_ms`` is the back-to-back time beside
    it, which is what the other kernels' ``ms`` is."""
    from kosmosx_torch.ops import roofline as rl

    b, h, l, d = FLASH_SHAPE
    attn = dict(causal=True, xpos=True)
    main_bwd = bwd["causal_xpos_bfloat16"]
    bf16_bwd = [r for k, r in bwd.items() if k.endswith("bfloat16")]

    def entry(name, source, replaces, err, case, work,
              peak=rl.H100_BF16_FLOPS):
        bound_ms, bound_by = rl.bound(work, peak)
        out = {"name": name, "route": "cuda",
               "source": f"kosmosx_torch/csrc/{source}",
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": case["ms"],
               "plain_ms": case["plain_ms"], "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": case.get("library_ms")}
        if "launch_ms" in case:
            out["launch_ms"] = case["launch_ms"]
        return out

    # the bf16 forward under xPos is two launches: the rotation kernel, then
    # the kernel on q' and k', which reads no tables. Its entry has the
    # kernel's time alone (ms) and with the rotation (with_prep_ms, the
    # rotation's own time and bound beside it); the library call's time
    # leaves the rotation out
    main_fwd = flash["causal_xpos_bfloat16"]
    prep_bound_ms, _ = rl.bound(
        rl.flash_fwd_prep_work(b, h, l, l, d), rl.H100_FP32_FLOPS)
    fwd = entry("flash_fwd", "flash_fwd.cu",
                "kosmosx_tpu/ops/flash_attention.py:174",
                max(r["max_abs_err"] for k, r in flash.items()
                    if k.endswith("bfloat16")),
                dict(main_fwd, ms=main_fwd["kernel_ms"]),
                rl.flash_fwd_work(b, h, l, l, d, causal=True))
    fwd.update(call_ms=main_fwd["ms"], prep_ms=main_fwd["prep_ms"],
               prep_bound_ms=prep_bound_ms,
               with_prep_ms=main_fwd["with_prep_ms"])
    kernels = [
        fwd,
        # no one library call rotates: library_ms None
        entry("flash_fwd_prep", "flash_bwd.cu",
              "kosmosx_tpu/ops/flash_attention.py:194",
              max(r["prep_max_abs_err"] for r in flash.values()
                  if "prep_max_abs_err" in r),
              dict(ms=main_fwd["prep_ms"], plain_ms=main_fwd["prep_plain_ms"],
                   launch_ms=main_fwd["prep_launch_ms"]),
              rl.flash_fwd_prep_work(b, h, l, l, d), rl.H100_FP32_FLOPS),
        decode_entry(entry, rl, decode),
        # no one library call rotates and takes the rowsum: library_ms None
        entry("flash_bwd_prep", "flash_bwd.cu",
              "kosmosx_tpu/ops/flash_attention.py:476",
              max(r["prep_max_abs_err"] for r in bf16_bwd),
              dict(ms=main_bwd["prep_ms"], plain_ms=main_bwd["prep_plain_ms"]),
              rl.flash_bwd_prep_work(b, h, l, l, d, xpos=True),
              rl.H100_FP32_FLOPS),
    ]
    for name, line, grads, work in (
            ("flash_bwd_dkv", 348, ("dk", "dv"), rl.flash_bwd_dkv_work),
            ("flash_bwd_dq", 411, ("dq",), rl.flash_bwd_dq_work)):
        short = name.split("_")[-1]
        # the library call computes dq, dk and dv together
        case = dict(ms=main_bwd[f"{short}_ms"],
                    plain_ms=main_bwd[f"{short}_plain_ms"],
                    library_ms=main_bwd.get("library_ms"))
        kernels.append(entry(
            name, "flash_bwd.cu", f"kosmosx_tpu/ops/flash_attention.py:{line}",
            max(r["max_abs_err"][n] for r in bf16_bwd for n in grads), case,
            work(b, h, l, l, d, **attn)))
    # the W8 wrappers' kernels by path: the 2-D entry's mma.sync kernel
    # (w8_bf16_kernel) at its one main-path call, the patch embedding; its
    # Hopper kernel (w8_bf16_hopper_kernel) at the vocab head, M = 4; and
    # the stacked entry's Hopper kernel at decode, L2-warm, with the
    # L2-cold time beside it
    vocab = (4, *W8_VOCAB)
    for name, line, main_case, lib_shape in (
            ("w8_matmul", 59, (514, 588, 1024, torch.bfloat16),
             (514, 588, 1024)),
            ("w8_matmul.hopper", 59, (*vocab, torch.bfloat16), vocab),
            ("w8_matmul_stacked", 156, ("stacked", 4, 11, torch.bfloat16),
             (4, 2048, 8192))):
        path = w8k[main_case]["path"]
        err = max(r["max_abs_err"] for key, r in w8k.items()
                  if key[-1] == torch.bfloat16 and r["path"] == path)
        lib = w8_lib.get(lib_shape, {})
        case = dict(w8k[main_case], library_ms=lib.get("library_ms"))
        kernels.append(dict(
            entry(name, "w8_matmul.cu", f"kosmosx_tpu/ops/quant_matmul.py:{line}",
                  err, case, rl.w8_matmul_work(*lib_shape)),
            kernel="w8_bf16_hopper_kernel" if path == "hopper"
            else "w8_bf16_kernel"))
        if "library_note" in lib:
            kernels[-1]["library_note"] = lib["library_note"]
    kernels[-1]["l2_cold_ms"] = w8k["stacked_l2_cold"]["layer_ms_l2_cold"]
    # the vocab head beside its main entry: at prefill (M = 3968) on the
    # Hopper kernel, and at M = 4 and 3968 on dense codes (the mma.sync
    # kernel, which took it before the codes had a padded pitch); a ViT FFN
    prefill = (3968, *W8_VOCAB)
    kernels[-2].update(
        prefill_ms=w8k[(*prefill, torch.bfloat16)]["ms"],
        prefill_bound_ms=rl.bound(rl.w8_matmul_work(*prefill),
                                  rl.H100_BF16_FLOPS)[0],
        prefill_library_ms=w8_lib[prefill]["library_ms"],
        dequant_bf16_gemm_ms={m: w8_lib[(m, *W8_VOCAB)]["dequant_bf16_gemm_ms"]
                              for m in (4, 3968)},
        dense_codes_mma_ms={m: w8k[("dense", m, *W8_VOCAB, torch.bfloat16)]["ms"]
                            for m in (4, 3968)},
        vit_ms=w8k[(*W8_VIT_SHAPE, torch.bfloat16)]["ms"])
    g, length, d_tile = TILE_MAIN
    kernels.append(entry(
        "tile_rate", "tile_rate.cu", "benchmarks/tile_rate_study.py:29",
        max(r["max_abs_err"] for r in tile.values()), tile[TILE_MAIN],
        rl.tile_rate_work(d_tile, g, length)))
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import kosmosx_torch
    from kosmosx_torch.ops import _build
    from kosmosx_torch.ops import decode_attention as da
    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.ops import layer_norm as ln
    from kosmosx_torch.ops import quant_matmul as qm
    from kosmosx_torch.ops import tile_rate as tr

    run_t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.library()
    build_log = (_build.build_dir() / "build.log").read_text().splitlines()
    sass = sass_counts(_build)
    hopper = ptxas_report(build_log)
    log("build", seconds=time.perf_counter() - t0,
        sources=[f"kosmosx_torch/csrc/{n}" for n in _build.SOURCES],
        nvcc_flags=" ".join(_build.NVCC_FLAGS),
        library=str(_build.build_dir() / _build.LIB_NAME),
        ptxas=[ln.strip() for ln in build_log
               if "Used" in ln or "spill" in ln],
        ptxas_warnings=[ln.strip() for ln in build_log
                        if "Performance Loss" in ln],
        sass=sass, hopper_kernels=hopper)
    for name in HOPPER_KERNELS:
        check(any(key.startswith(name) for key in sass),
              f"{name}: not in the built library's SASS")
    for name, ops in sass.items():
        need = next(v for k, v in SASS_REQUIRED.items() if name.startswith(k))
        check(all(ops[op] > 0 for op in need),
              f"{name}: {need} in its SASS: {ops}")
        check(name in hopper and hopper[name]["registers"] is not None,
              f"{name}: no ptxas register line")
        check(hopper[name]["spill_bytes"] == 0 and
              not hopper[name]["performance_loss"],
              f"{name}: spills or serialized wgmma: {hopper[name]}")

    flash = phase_flash(dev, fa)
    decode = phase_decode(dev, da)
    tile, tile_launches = phase_tile_rate(dev, tr)
    torch.cuda.empty_cache()
    layer_norm = phase_layer_norm(dev, ln)
    torch.cuda.empty_cache()
    lfm2 = phase_lfm2(dev)
    torch.cuda.empty_cache()
    phase_lfm2_forward(dev)
    lion_row = phase_lion(dev, kosmosx_torch)
    phase_reference(dev, kosmosx_torch)
    torch.cuda.empty_cache()
    model, cfg = phase_forward(dev, kosmosx_torch, fa)
    phase_ref_roundtrip(dev, kosmosx_torch, model, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    launches, bf16_gen = phase_generate(dev, kosmosx_torch, fa, da, model, cfg)
    decode_phases = {"6_generate": launches["decode"],
                     "6e_int8_kv": phase_int8_kv(dev, fa, da, model, cfg,
                                                 bf16_gen),
                     "6f_window": phase_window(dev, da, model, cfg)}
    beam_spec, spec6g = phase_beam_speculative(dev, da, model, cfg)
    decode_phases.update({"6g_beam": beam_spec["beam"],
                          "6g_speculative": beam_spec["speculative"]})
    gc.collect()
    torch.cuda.empty_cache()
    phase_distill(dev, model, cfg, spec6g)
    gc.collect()
    torch.cuda.empty_cache()
    phase_cli()
    gc.collect()
    torch.cuda.empty_cache()
    engine = phase_engine(dev, fa, da, model, cfg)
    decode_phases["6i_engine"] = engine["decode_launches"]
    gc.collect()
    torch.cuda.empty_cache()
    exact = phase_engine_exact(dev, kosmosx_torch, da)
    decode_phases["6j_engine_fp32"] = exact["decode_launches"]
    phase_http_cli(dev, exact)
    del exact
    gc.collect()
    torch.cuda.empty_cache()
    w8k = phase_w8_kernels(dev, qm)
    w8_lib = phase_w8_library(dev, qm)
    torch.cuda.empty_cache()
    phase_w8_reference(dev, kosmosx_torch, qm)
    torch.cuda.empty_cache()
    w8, w8_cfg = phase_w8_forward(dev, kosmosx_torch, fa, qm, model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    w8_launches = phase_w8_generate(dev, fa, da, qm, w8, w8_cfg, bf16_gen)
    decode_phases["6k_w8_engine"] = phase_w8_engine(
        dev, qm, da, w8, w8_cfg, engine)["decode"]
    del w8
    gc.collect()
    torch.cuda.empty_cache()
    bwd = phase_flash_bwd(dev, fa)
    torch.cuda.empty_cache()
    phase_grad_reference(dev, kosmosx_torch, fa)
    gc.collect()
    torch.cuda.empty_cache()
    phase_dropout_remat(dev, kosmosx_torch, fa)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_reading = phase_train(dev, kosmosx_torch, fa)
    gc.collect()
    torch.cuda.empty_cache()
    flash_phases = {name: {"9_train": train_launches[name]}
                    for name in FLASH_KERNELS}
    for phase, fn in (("9b_train_real", phase_train_real),
                      ("9c_train_1chip", phase_train_1chip)):
        for name, n in fn(dev, kosmosx_torch, fa).items():
            flash_phases[name][phase] = n
        gc.collect()
        torch.cuda.empty_cache()
    for name, by_phase in phase_cli_train_eval(dev).items():
        flash_phases[name].update(by_phase)
    phase_w8_grad(dev, qm)
    gc.collect()
    torch.cuda.empty_cache()
    phase_lora_reference(dev, kosmosx_torch, fa, qm)
    gc.collect()
    torch.cuda.empty_cache()
    lora = phase_lora_train(dev, kosmosx_torch, fa, qm, train_reading)
    gc.collect()
    torch.cuda.empty_cache()
    qlora = phase_qlora_train(dev, kosmosx_torch, fa, qm, {
        k: lora[k] for k in ("step_s_mean_3_8", "tokens_per_s",
                             "peak_mem_bytes")})
    gc.collect()
    torch.cuda.empty_cache()
    dpo = phase_dpo(dev, kosmosx_torch, fa)
    for phase, run in (("10c_lora", lora), ("10d_qlora", qlora),
                       ("10e_dpo", dpo)):
        for name in FLASH_KERNELS:
            flash_phases[name][phase] = run["launches"][name]
    gc.collect()
    torch.cuda.empty_cache()
    phase_moe_ffn(dev, kosmosx_torch)
    gc.collect()
    torch.cuda.empty_cache()
    moe_fwd, moe, moe_cfg = phase_moe_forward(dev, kosmosx_torch, fa)
    moe_gen = phase_moe_generate(dev, fa, da, moe, moe_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    moe_eng = phase_moe_engine(dev, kosmosx_torch, fa, da, moe, moe_cfg)
    del moe
    gc.collect()
    torch.cuda.empty_cache()
    moe_train = phase_moe_train(dev, kosmosx_torch, fa)
    gc.collect()
    torch.cuda.empty_cache()
    phase_moe_cli(dev, kosmosx_torch)
    decode_phases.update({"11c_moe_generate": moe_gen["launches"]["decode"],
                          "11d_moe_engine": moe_eng["decode_launches"]})
    for name in ("flash_fwd", "flash_fwd_prep"):
        flash_phases[name]["11b_moe_forward"] = moe_fwd["launches"][name]
    flash_phases["flash_fwd"].update({
        "11c_moe_generate": moe_gen["launches"]["flash"],
        "11d_moe_engine": moe_eng["flash_launches"]})
    for name in FLASH_KERNELS:
        flash_phases[name]["11e_moe_train"] = moe_train["launches"][name]
    gc.collect()
    torch.cuda.empty_cache()
    zoo, zoo_cond, zoo_x = phase_zoo_conditional(dev, kosmosx_torch, fa)
    phase_zoo_lean(dev, kosmosx_torch, zoo_cond)
    gc.collect()
    torch.cuda.empty_cache()
    zoo_any = phase_zoo_any(dev, kosmosx_torch, fa, zoo_cond)
    gc.collect()
    torch.cuda.empty_cache()
    zoo_grad = phase_zoo_grad(dev, fa, zoo_cond, zoo_x)
    del zoo_cond, zoo_x
    gc.collect()
    torch.cuda.empty_cache()
    phase_zoo_r3d18(dev, kosmosx_torch)
    for name in ("flash_fwd", "flash_fwd_prep"):
        flash_phases[name]["12a_conditional"] = zoo["launches"][name]
        flash_phases[name]["12c_any_unified"] = \
            zoo_any["unified"]["launches"][name]
    for name in FLASH_KERNELS:
        flash_phases[name]["12d_conditional_grad"] = zoo_grad["launches"][name]
    gc.collect()
    torch.cuda.empty_cache()
    ring = phase_ring(dev)
    sp = phase_sp(dev)
    phase_cli_distributed(dev)
    for name in FLASH_KERNELS:
        flash_phases[name]["13a_ring"] = ring[name]
        flash_phases[name]["13b_sp_step"] = sp[name]
    for phase, fn in (("14a_tp_train", phase_tp_train), ("14c_ep", phase_ep),
                      ("14d_pp", phase_pp)):
        for name, n in fn(dev).items():
            flash_phases[name][phase] = n
    decode_phases["14b_tp_serve"] = phase_tp_serve(dev)["decode"]
    tp_w8 = phase_tp_w8(dev, qm)
    decode_phases["14e_tp_w8"] = tp_w8["launches"]["decode_attention"]
    for name in FLASH_KERNELS:
        flash_phases[name]["14e_tp_w8"] = tp_w8["launches"].get(name, 0)

    kernels = kernels_line(flash, decode, bwd, w8k, w8_lib, tile, {
        "flash_fwd": launches["flash"], "decode_attention": launches["decode"],
        "flash_fwd_prep": train_launches["flash_fwd_prep"],
        "flash_bwd_prep": train_launches["flash_bwd_prep"],
        "flash_bwd_dkv": train_launches["flash_bwd_dkv"],
        "flash_bwd_dq": train_launches["flash_bwd_dq"],
        "w8_matmul": w8_launches["w8_matmul.mma"],
        "w8_matmul.hopper": w8_launches["w8_matmul.hopper"],
        "w8_matmul_stacked": w8_launches["w8_matmul_stacked"],
        "tile_rate": tile_launches})
    kernels += layer_norm_entries(layer_norm)
    kernels += lfm2
    kernels.append(lion_row)
    # the decode kernel's launches in every phase that generates, the flash
    # kernels' in every training phase (9d's counted in the CLIs' children),
    # the W8 kernels' under autograd in 10d (the 2-D wrapper's entry
    # "w8_matmul" is its mma.sync kernel, as in the generation run)
    ql, tl = qlora["launches"], tp_w8["launches"]
    w8_phases = {
        "w8_matmul": {"10d_qlora": ql["w8_matmul"] - ql["w8_matmul.hopper"],
                      "14e_tp_w8": 0},
        "w8_matmul.hopper": {"10d_qlora": ql["w8_matmul.hopper"],
                             "14e_tp_w8": tl["w8_matmul.hopper"]},
        "w8_matmul_stacked": {"10d_qlora": ql["w8_matmul_stacked"],
                              "14e_tp_w8": tl["w8_matmul_stacked"]}}
    next(k for k in kernels if k["name"] == "decode_attention")[
        "launches_by_phase"] = decode_phases
    for k in kernels:
        if k["name"] in flash_phases:
            k["launches_by_phase"] = flash_phases[k["name"]]
        elif k["name"] in w8_phases:
            k["launches_by_phase"] = w8_phases[k["name"]]
    # the W8 kernels at a rank's decode shapes under 14e, with their bounds
    times = tp_w8["times"]
    by_name = {k["name"]: k for k in kernels}
    by_name["w8_matmul_stacked"]["tensor_rank_m8"] = {
        stack: {key: t[key] for key in ("ms", "plain_ms", "launch_ms",
                                        "bound_ms")}
        for stack, t in times.items() if stack != "vocab_head"}
    by_name["w8_matmul.hopper"]["tensor_rank_m8"] = {
        key: times["vocab_head"][key] for key in ("ms", "plain_ms",
                                                  "launch_ms", "bound_ms")}
    log("wall", seconds=time.perf_counter() - run_t0)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--int8pack"] and torch.cuda.is_available():
        sys.exit(int8pack_main(int(sys.argv[2])))
    if sys.argv[1:2] == ["--cli"] and torch.cuda.is_available():
        runs, cur = [], []
        for arg in sys.argv[2:] + ["--then"]:
            if arg == "--then":
                runs.append((cur[0], cur[1:]))
                cur = []
            else:
                cur.append(arg)
        sys.exit(cli_child(runs))
    if sys.argv[1:2] == ["--rank"] and torch.cuda.is_available():
        sys.exit(rank_main(sys.argv[2]))
    sys.exit(main())
