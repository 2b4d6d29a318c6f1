#!/usr/bin/env python3
"""Where the time goes in kosmosx_torch's serving and training slices, on
one NVIDIA GPU.

    python3 chip_profile.py [--out profile.json]
                            [--only serve|w8|kv|engine|train|lora|moe|zoo]

Builds the flagship ``Kosmos`` of ``chip_smoke.py`` (bf16, random weights
from a seed) and times, after a warm-up, four things by the host clock
around ``torch.cuda.synchronize()`` (two unprofiled runs each) and then
once more under ``torch.profiler``:

- ``encode_images`` for 2 images;
- ``Kosmos.apply`` at 2 x (1920 text + 64 image) positions;
- generation prefill: ``generate_multimodal`` with one new token for the
  4 requests of ``chip_smoke.py`` (one image, 192/256/320/448 text tokens);
- the same with 32 new tokens; a decode step is (32 tokens - prefill) / 31;
- the forward, prefill and decode steps again on the weight-only int8 (W8)
  model that ``chip_smoke.py`` quantizes from the bf16 one (decoder in the
  stacked layout, the W8 kernels on every projection);
- KV-cache modes (``--only kv``): a decode step of the same requests with
  an int8 KV cache ((32 tokens - prefill) / 31), and a decode step of
  ``chip_smoke.py``'s rolling-window run (phase 6f: 512 slots, 4 sinks),
  timed over 16 steps resumed from the loop's state after 300 steps,
  where every row's writes have wrapped;
- the serving engine (``--only engine``): one batched admission of 8 text
  requests (8 x 512 positions) and the steady-state step of
  ``chip_smoke.py`` phase 6i's pool with 8 slots decoding, timed over 16
  ``step()`` calls, with ``ServeEngine.phase_s`` (the host loop's admit,
  prep, dispatch, post and drain time) per step, and the reader thread's
  waits on the card (its ``serve.reader_wait`` spans) over 16 more steps,
  traced;
- one training step of ``chip_smoke.py``'s flagship recipe (fp32 parameters,
  bf16 compute, remat "dots", CLIP frozen, Lion, 2 x 2048 positions), the
  serving model freed first;
- the optimizer step of that recipe alone (clip and Lion over the trainable
  parameters), whose device time is the training step's optimizer share,
  then AdamW8bit's and Lion8bit's (blockwise-int8 moments) on the same
  gradients;
- LoRA (``--only lora``): one step of ``chip_smoke.py`` phase 10c's LoRA
  recipe (rank 16, AdamW) on that model, and one of 10d's QLoRA recipe on
  its W8 copy (bf16, the decoder stacked);
- the mixture-of-experts decoder (``--only moe``): phase 11b's forward and
  11e's training step, with the MoE FFN's device time split into the
  expert products, the routing and the dispatch, combine and router;
- the modality zoo (``--only zoo``): phase 12a's ``KosmosConditional``
  forward, with each tower's device time and the decoder's layer stack's.

The device time of each profiled run is summed by kernel group (GEMM,
cuDNN convolutions, elementwise and copies, reductions, the flash forward's
rotation kernel and the forward kernel, the flash backward's pre-pass, dK/dV
and dQ kernels, the decode kernel, the W8 matmul kernels, other), with each
group's kernel launches; the busy share is that sum over the unprofiled
wall time. It prints one JSON line per workload and, with ``--out``, writes
them there together with each workload's 15 longest kernel names. Without
a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import pathlib
import sys
import time

import torch

GROUPS = (  # first match wins; names lower-cased
    ("flash_fwd_prep", ("flash_fwd_prep",)),
    ("flash", ("flash_fwd",)),
    ("flash_bwd_prep", ("flash_bwd_prep",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("decode_kernel", ("decode_split_kernel", "decode_kernel")),
    ("w8_matmul", ("w8_bf16_hopper_kernel", "w8_bf16_kernel", "w8_f32_kernel",
                   "w8_reduce_kernel")),
    ("conv", ("cudnn", "convolve", "fprop", "dgrad", "wgrad", "conv_")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "gemv")),
    ("reduce", ("reduce",)),
    ("elementwise_copy", ("elementwise", "copy", "memcpy", "memset", "cat",
                          "index", "scatter", "gather", "fill")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_breakdown(prof, ranges=()) -> dict:
    """Device time (ms) by kernel group, kernel count and the top kernels;
    the device-side spans of the ``record_function`` labels in ``ranges``
    are not kernels and are left out."""
    groups = {g: 0.0 for g, _ in GROUPS} | {"other": 0.0}
    launches = dict.fromkeys(groups, 0)
    top = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.key in ranges:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        groups[group_of(evt.key)] += us / 1e3
        launches[group_of(evt.key)] += evt.count
        top.append((us / 1e3, evt.count, evt.key[:120]))
    top.sort(reverse=True)
    return {"device_ms": sum(groups.values()), "groups_ms": groups,
            "kernels": sum(launches.values()), "groups_launches": launches,
            "top": top[:15]}


def ranges_ms(prof, ranges) -> dict:
    """Device time (ms) of the kernels launched inside each host-side
    ``record_function`` range of ``ranges``, nested ranges included: the
    kernels of the range's operators and of theirs, summed. The device-side
    span the profiler also links to a range is not a kernel and is left
    out (it covers idle time too)."""
    def kernels_us(evt):
        own = sum(k.duration for k in evt.kernels if k.name not in ranges)
        return own + sum(kernels_us(c) for c in evt.cpu_children)

    cpu = torch.autograd.DeviceType.CPU
    return {label: sum(kernels_us(e) for e in prof.events()
                       if e.name == label and e.device_type == cpu) / 1e3
            for label in ranges}


def measure(name: str, fn, runs: int = 2, ranges=()) -> dict:
    """Two unprofiled runs after a warm-up, then one under the profiler;
    ``ranges``: ``record_function`` labels whose device time (the kernels
    launched inside them, nested ranges included) is reported under
    ``ranges_ms``."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    wall = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled = (time.perf_counter() - t0) * 1e3
    out = {"workload": name, "wall_ms": wall, "profiled_wall_ms": profiled}
    out.update(device_breakdown(prof, ranges))
    if ranges:
        out["ranges_ms"] = ranges_ms(prof, ranges)
    out["busy_share"] = out["device_ms"] / (sum(wall) / len(wall))
    return out


def per_step(full: dict, prefill: dict, steps: int) -> dict:
    """Decode step = (generation - prefill) / steps, field by field; with no
    ``prefill`` (a run of decode steps alone), full / steps."""
    def diff(a, b):
        return (a - b) / steps

    zero = {"wall_ms": [0.0] * len(full["wall_ms"]), "profiled_wall_ms": 0.0,
            "device_ms": 0.0, "kernels": 0,
            "groups_ms": dict.fromkeys(full["groups_ms"], 0.0),
            "groups_launches": dict.fromkeys(full["groups_launches"], 0)}
    prefill = prefill or zero
    wall = [diff(a, b) for a, b in zip(full["wall_ms"], prefill["wall_ms"])]
    device = diff(full["device_ms"], prefill["device_ms"])
    return {"workload": f"decode step (mean of {steps})", "wall_ms": wall,
            "profiled_wall_ms": diff(full["profiled_wall_ms"],
                                     prefill["profiled_wall_ms"]),
            "device_ms": device,
            "groups_ms": {g: diff(full["groups_ms"][g], prefill["groups_ms"][g])
                          for g in full["groups_ms"]},
            "kernels": diff(full["kernels"], prefill["kernels"]),
            "groups_launches": {
                g: diff(full["groups_launches"][g],
                        prefill["groups_launches"][g])
                for g in full["groups_launches"]},
            "busy_share": device / (sum(wall) / len(wall))}


def train_workloads(kosmosx_torch, dev) -> list:
    """One flagship training step, and its optimizer step alone: Lion, and
    AdamW8bit and Lion8bit on the same gradients."""
    from chip_smoke import SEED, train_batch, train_config
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.train.optim import make_optimizer
    from kosmosx_torch.train.trainer import (TrainConfig, Trainer,
                                             kosmos_loss_fn, value_and_grad)

    cfg = train_config(kosmosx_torch)
    trainer = Trainer(lambda g: Kosmos(cfg, generator=g, device=dev),
                      kosmos_loss_fn(cfg),
                      TrainConfig(optimizer="lion", schedule="constant",
                                  warmup_steps=1, freeze=("clip",),
                                  seed=SEED + 8), device=dev)
    state = trainer.init_state()
    step = trainer._build_step()
    batch = trainer.place_batch(train_batch(cfg))
    model, rng = state["params"], state["rng"]
    results = [measure("train step, 2 x 2048 (Lion, remat dots, CLIP frozen)",
                       lambda: step(model, batch, rng))]
    _, grads = value_and_grad(trainer._loss_fn, model, batch,
                              freeze=("clip",))
    results.append(measure("optimizer step alone (clip + Lion)",
                           lambda: trainer.optimizer.step(grads)))
    trainable = trainer.optimizer.params
    for name in ("adamw8bit", "lion8bit"):
        opt = make_optimizer(name, trainer.schedule, trainable)
        results.append(measure(f"optimizer step alone (clip + {name})",
                               lambda: opt.step(grads)))
        del opt
    return results


def serve_workloads(kosmosx_torch, dev, w8: bool = False) -> list:
    """The flagship forward, image encoding, prefill and decode steps; with
    ``w8``, on the W8 copy of the bf16 model (the bf16 model freed)."""
    from chip_smoke import SEED, flagship_config, pixels, w8_model
    from kosmosx_torch.generate.sampler import SamplingConfig, generate_multimodal
    from kosmosx_torch.models.kosmos import Kosmos

    cfg = flagship_config(kosmosx_torch)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    model = Kosmos(cfg, generator=g, device=dev).to(torch.bfloat16)
    if w8:
        model, cfg = w8_model(model, cfg)
        gc.collect()
        torch.cuda.empty_cache()
    tag = "W8 " if w8 else ""
    fwd_tokens = torch.randint(4, cfg.decoder.vocab_size, (2, 1920),
                               generator=g, device=dev)
    fwd_images = pixels(2, g, dev)
    gcfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, decode_attn_kernel=True))
    lengths = torch.tensor([192, 256, 320, 448], device=dev)
    tokens = torch.randint(4, cfg.decoder.vocab_size, (4, 448), generator=g,
                           device=dev)
    tokens[torch.arange(448, device=dev)[None] >= lengths[:, None]] = \
        cfg.decoder.padding_idx
    images = pixels(4, g, dev)
    new = 32

    def generate(n):
        return generate_multimodal(model, gcfg, tokens, images,
                                   SamplingConfig(max_new_tokens=n, greedy=True),
                                   prompt_lengths=lengths)

    with torch.inference_mode():
        results = [measure(tag + "encode_images, 2 images",
                           lambda: model.encode_images(fwd_images)),
                   measure(tag + "Kosmos.apply, 2 x 1984",
                           lambda: model.apply(fwd_tokens, fwd_images))]
        prefill = measure(tag + "generation prefill, 4 x 512",
                          lambda: generate(1))
        full = measure(tag + f"generation, 4 x {new} tokens",
                       lambda: generate(new))
    step = per_step(full, prefill, new - 1)
    step["workload"] = tag + step["workload"]
    return results + [prefill, full, step]


def kv_workloads(kosmosx_torch, dev) -> list:
    """A decode step over an int8 KV cache (``chip_smoke.py`` phase 6e's
    shape, phase 6's requests) and over a wrapped rolling window (phase
    6f), on the bf16 flagship."""
    from chip_smoke import (SEED, WINDOW_NEW, flagship_config,
                            generation_requests, window_config,
                            window_requests)
    from kosmosx_torch.generate import sampler
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.nn import decoder as dec

    cfg = flagship_config(kosmosx_torch)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    model = Kosmos(cfg, generator=g, device=dev).to(torch.bfloat16)
    gcfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, decode_attn_kernel=True, kv_cache_dtype="int8"))
    tokens, lengths, images = generation_requests(dev, cfg)
    new = 32

    def generate(n):
        return sampler.generate_multimodal(
            model, gcfg, tokens, images,
            sampler.SamplingConfig(max_new_tokens=n, greedy=True),
            prompt_lengths=lengths)

    with torch.inference_mode():
        prefill = measure("int8-KV generation prefill, 4 x 512",
                          lambda: generate(1))
        full = measure(f"int8-KV generation, 4 x {new} tokens",
                       lambda: generate(new))
    int8_step = per_step(full, prefill, new - 1)
    int8_step["workload"] = "int8-KV " + int8_step["workload"]

    dcfg = window_config(cfg)
    params = model["decoder"]
    prompt, plens = window_requests(dev, cfg)
    warm, steps = 300, 16
    scfg = sampler.SamplingConfig(max_new_tokens=warm, greedy=True)
    with torch.inference_mode():
        x, _ = dec.forward_embedding(params, dcfg, prompt)
        _, state = sampler._generate(params, dcfg, x, plens, scfg,
                                     prompt.shape[1] + WINDOW_NEW, None, False)
        # each call decodes the same steps again from the same state
        window = measure(f"window decode, {steps} steps after {warm}",
                         lambda: sampler._decode(
                             params, dcfg, dataclasses.replace(state), steps,
                             scfg, None))
    window_step = per_step(window, None, steps)
    window_step["workload"] = "window " + window_step["workload"]
    return [prefill, full, int8_step, window, window_step]


def engine_workloads(kosmosx_torch, dev) -> list:
    """The serving engine of ``chip_smoke.py`` phase 6i (the bf16 flagship,
    ``decode_attn_kernel=True``, ``ServeEngine(max_batch=8,
    max_prompt_len=512, max_len=1024, sync_lag=4)``): one batched admission
    of 8 text requests (a prefill of 8 x 512 positions and the pool
    inserts), and the steady-state step with all 8 slots decoding, timed
    over 16 ``step()`` calls, with the host loop's phases
    (``ServeEngine.phase_s``) per step beside the device breakdown."""
    from chip_smoke import SEED, flagship_config
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.serve import ServeConfig, ServeEngine
    from kosmosx_torch.utils import trace

    cfg = flagship_config(kosmosx_torch)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    model = Kosmos(cfg, generator=g, device=dev).to(torch.bfloat16)
    ecfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, decode_attn_kernel=True))
    eng = ServeEngine(model, ecfg.decoder,
                      ServeConfig(max_batch=8, max_prompt_len=512,
                                  max_len=1024, sync_lag=4),
                      kosmos_cfg=ecfg, device=dev)
    gh = torch.Generator().manual_seed(SEED + 20)
    prompts = [torch.randint(4, cfg.decoder.vocab_size, (n,),
                             generator=gh).tolist()
               for n in torch.randint(64, 481, (8,), generator=gh).tolist()]

    def admit():
        """One batched admission into the 8 free slots."""
        eng.slots = [None] * 8
        eng._inflight.clear()
        pairs = [(s, eng.submit(p, max_new_tokens=400))
                 for s, p in enumerate(prompts)]
        eng.pending.clear()
        eng._admit_many(pairs)

    steps = 16
    with torch.inference_mode():
        admission = measure("engine batched admission, 8 x 512", admit)
        admit()
        for _ in range(8):
            eng.step()
        full = measure(f"engine, {steps} steps of 8 decoding slots",
                       lambda: [eng.step() for _ in range(steps)])
        # the host loop's phases over unprofiled, untraced steps
        eng.reset_counters()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        phase_s = dict(eng.phase_s)
        # then, over as many steps traced, the reader thread's waits on
        # the card (its serve.reader_wait spans)
        trace.clear()
        with trace.enable():
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
    waits = [r for r in trace.records() if r.name == "serve.reader_wait"]
    trace.clear()
    step = per_step(full, None, steps)
    step["workload"] = "engine " + step["workload"]
    step["phase_ms_per_step"] = {k: v * 1e3 / steps
                                 for k, v in phase_s.items()}
    step["reader_wait_ms_per_step"] = sum(
        r.end - r.start for r in waits) / 1e6 / steps
    return [admission, full, step]


def lora_workloads(kosmosx_torch, dev) -> list:
    """One LoRA training step of ``chip_smoke.py`` phase 10c's recipe (rank
    16 on the default targets, AdamW; the flagship with fp32 parameters,
    remat "dots", 2 x 2048 positions) and one QLoRA step of 10d's (the
    same model in bf16, quantized W8 with the decoder stacked)."""
    from chip_smoke import LORA_RANK, SEED, train_batch, train_config, w8_model
    from kosmosx_torch.models.kosmos import Kosmos
    from kosmosx_torch.train.lora import LoraTrainer
    from kosmosx_torch.train.trainer import TrainConfig, kosmos_loss_fn

    results = []
    for name in ("LoRA", "QLoRA"):
        cfg = train_config(kosmosx_torch)
        base = Kosmos(cfg, generator=torch.Generator(device=dev).manual_seed(
            SEED + 8), device=dev)
        if name == "QLoRA":
            base, cfg = w8_model(base.to(torch.bfloat16), cfg)
        trainer = LoraTrainer(None, kosmos_loss_fn(cfg), TrainConfig(
            optimizer="adamw", learning_rate=1e-3, schedule="constant",
            warmup_steps=1, seed=SEED + 23), rank=LORA_RANK,
            base_params=base, device=dev)
        state = trainer.init_state()
        step = trainer._build_step()
        batch = trainer.place_batch(train_batch(cfg))
        results.append(measure(
            f"{name} train step, rank {LORA_RANK}, 2 x 2048 (AdamW, remat "
            f"dots)", lambda: step(state, base, batch)))
        del trainer, state, step, base
        gc.collect()
        torch.cuda.empty_cache()
    return results


MOE_RANGES = ("moe.ffn", "moe.routing", "moe.experts")


@contextlib.contextmanager
def ranged_calls(*calls):
    """Each call of ``module.name`` under a ``record_function`` range
    ``label``, for every (module, name, label) of ``calls``."""
    from torch.profiler import record_function

    saved = []
    for module, name, label in calls:
        real = getattr(module, name)
        saved.append((module, name, real))

        def ranged(*args, _real=real, _label=label, **kwargs):
            with record_function(_label):
                return _real(*args, **kwargs)

        setattr(module, name, ranged)
    try:
        yield
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


def moe_ranges():
    """Each ``moe_ffn`` call, and inside it the routing (``_routing``) and
    the experts' FFN (``_expert_ffn``: fc1, the activation, sub-LN, fc2),
    under a ``record_function`` range of ``MOE_RANGES``."""
    from kosmosx_torch.nn import decoder, moe

    return ranged_calls((decoder, "moe_ffn", "moe.ffn"),
                        (moe, "_routing", "moe.routing"),
                        (moe, "_expert_ffn", "moe.experts"))


def moe_split(result: dict) -> dict:
    """The MoE FFN's device time split: expert FFN, routing, and the rest
    of ``moe_ffn`` (router, softmax, aux losses, dispatch scatter, combine
    gather), each with its share of the workload's device time."""
    r = result.pop("ranges_ms", {})
    ffn = r.get("moe.ffn") or 0.0
    parts = {"experts_ms": r.get("moe.experts") or 0.0,
             "routing_ms": r.get("moe.routing") or 0.0}
    parts["dispatch_combine_router_ms"] = ffn - sum(parts.values())
    dev = result["device_ms"]
    return dict(moe_ffn_ms=ffn, **parts, moe_ffn_share=ffn / dev,
                **{k.replace("_ms", "_share"): v / dev for k, v in parts.items()})


def moe_workloads(kosmosx_torch, dev) -> list:
    """``chip_smoke.py`` phase 11b's MoE forward (``decoder_forward(
    with_aux=True)``, bf16, 4 x 2048) and 11e's training step (fp32
    parameters, bf16 compute, Lion, remat "dots", 2 x 2048), with the MoE
    FFN's share split into the expert products, the routing and the rest
    (``moe_split``). In the training step the ranges hold the forward and
    its recomputation; the backward's kernels fall outside them."""
    from chip_smoke import (MOE_BATCH, MOE_SEQ, SEED, moe_config, moe_model)
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.nn.decoder import decoder_forward
    from kosmosx_torch.train.data import synthetic_text_batches
    from kosmosx_torch.train.trainer import TrainConfig, Trainer, lm_loss_fn

    model, cfg = moe_model(dev, kosmosx_torch, SEED + 31)
    tokens = torch.randint(4, cfg.vocab_size, (MOE_BATCH, MOE_SEQ),
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED + 32), device=dev)
    with torch.inference_mode(), moe_ranges():
        fwd = measure(f"MoE decoder_forward, {MOE_BATCH} x {MOE_SEQ}",
                      lambda: decoder_forward(model, tokens, cfg,
                                              with_aux=True),
                      ranges=MOE_RANGES)
    fwd.update(moe_split(fwd))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = moe_config(kosmosx_torch, remat=True, remat_policy="dots")
    trainer = Trainer(lambda g: KosmosLanguage(mcfg, generator=g, device=dev),
                      lm_loss_fn(mcfg),
                      TrainConfig(optimizer="lion", schedule="constant",
                                  warmup_steps=1, seed=SEED + 39), device=dev)
    state = trainer.init_state()
    step = trainer._build_step()
    batch = trainer.place_batch(next(synthetic_text_batches(
        batch_size=2, seq_len=MOE_SEQ, vocab_size=mcfg.vocab_size,
        seed=SEED)))
    with moe_ranges():
        train = measure(f"MoE train step, 2 x {MOE_SEQ} (Lion, remat dots)",
                        lambda: step(state["params"], batch, state["rng"]),
                        ranges=MOE_RANGES)
    train.update(moe_split(train))
    return [fwd, train]


ZOO_RANGES = ("zoo.image", "zoo.audio", "zoo.video", "zoo.decoder")


def zoo_workloads(kosmosx_torch, dev) -> list:
    """``chip_smoke.py`` phase 12a's forward: ``KosmosConditional.apply``
    with ViT-L/14 and the resampler, wav2vec2-base and r3d18 (fp32) on the
    flagship decoder (bf16 compute over fp32 parameters), 2 x (1024 text +
    66 media) positions, with each tower's device time (``ranges_ms``: the
    ViT and resampler, the audio encoder, the video encoder) and the
    decoder's layer stack's."""
    import chip_smoke as cs
    from kosmosx_torch.models import conditional
    from kosmosx_torch.nn import decoder

    cfg = cs.zoo_configs(kosmosx_torch)
    model = conditional.KosmosConditional(
        ("text", "image", "audio", "video"), **cfg,
        generator=torch.Generator(device=dev).manual_seed(cs.SEED + 51),
        device=dev)
    x = cs.zoo_inputs(dev, cfg["decoder"], cs.SEED + 52)
    with torch.inference_mode(), ranged_calls(
            (conditional, "clip_vit", "zoo.image"),
            (conditional, "resampler", "zoo.image"),
            (conditional, "audio_encoder", "zoo.audio"),
            (conditional, "video_encoder", "zoo.video"),
            (decoder, "run_layers", "zoo.decoder")):
        fwd = measure(f"KosmosConditional.apply, 2 x ({cs.ZOO_TEXT} + 66)",
                      lambda: model.apply(**x), ranges=ZOO_RANGES)
    return [fwd]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="JSON file for the full results")
    ap.add_argument("--only", choices=("serve", "w8", "kv", "engine",
                                       "train", "lora", "moe", "zoo"),
                    help="profile one slice only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this script runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import kosmosx_torch
    from chip_smoke import nvidia_smi_line

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    results = []
    for slice_, w8 in (("serve", False), ("w8", True)):
        if args.only in (None, slice_):
            results += serve_workloads(kosmosx_torch, dev, w8=w8)
            gc.collect()
            torch.cuda.empty_cache()
    if args.only in (None, "kv"):
        results += kv_workloads(kosmosx_torch, dev)
        gc.collect()
        torch.cuda.empty_cache()
    if args.only in (None, "engine"):
        results += engine_workloads(kosmosx_torch, dev)
        gc.collect()
        torch.cuda.empty_cache()
    if args.only in (None, "train"):
        results += train_workloads(kosmosx_torch, dev)
        gc.collect()
        torch.cuda.empty_cache()
    if args.only in (None, "lora"):
        results += lora_workloads(kosmosx_torch, dev)
        gc.collect()
        torch.cuda.empty_cache()
    if args.only in (None, "moe"):
        results += moe_workloads(kosmosx_torch, dev)
        gc.collect()
        torch.cuda.empty_cache()
    if args.only in (None, "zoo"):
        results += zoo_workloads(kosmosx_torch, dev)
    for r in results:
        print(json.dumps({k: v for k, v in r.items() if k != "top"}), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"nvidia_smi": smi, "results": results},
                                  indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
