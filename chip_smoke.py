#!/usr/bin/env python3
"""Drive kosmosx_torch's serving, W8 and training slices once on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels compiled from ``kosmosx_torch/csrc`` for sm_90a;
3. the flash-attention kernel against its plain PyTorch version at the
   flagship's attention shape (2, 32, 2048, 64): causal with fused xPos,
   causal with ragged padding segments, non-causal, in bf16 (bar 2e-2) and
   fp32 (bar 1e-4, TF32 off); the (l, m) statistics against the plain
   version's too;
4. the decode-attention kernel against its plain version: (8, 32, 1, 64)
   queries over a (8, 32, 2048, 64) cache with ragged kv_len, bf16 (bar 2e-2)
   and int8 codes with scales (bar 5e-2), each also within 1e-2 of every
   output row's magnitude, and both again with an fp32 query (bar 1e-5);
5. the flagship ``Kosmos.apply`` in bf16 at 2 x (1920 text + 64 image)
   positions from a seeded random init: finite logits of the right shape, the
   flash kernel launched; and, on a depth-cut fp32 copy at full width, the
   kernel path against the plain-attention path (bar 1e-3);
6. greedy ``generate_multimodal`` with ``decode_attn_kernel=True``: 4 requests
   of one 224x224 image and 192/256/320/448 text tokens, 32 new tokens each;
   ids in the vocabulary, two runs identical, both kernels launched;
6a. the W8 kernels (``w8_matmul``, ``w8_matmul_stacked``) against their
   plain version at decode M 4 and 8 over (2048, 2048), (2048, 8192),
   (8192, 2048) and the vocab head's (2048, 32002), prefill M 3968 over
   (2048, 8192), the ragged (5, 130, 70) and (514, 588, 1024), and a
   (24, 2048, 8192) stack at layers 0, 11 and 23 with M 4 and 3968; fp32
   (TF32 off, bar 1e-5) and bf16 (bar 1e-2: the plain version rounds twice,
   the kernel once), relative to the reference's largest value; device
   times from CUDA graphs, beside back-to-back launch times;
6b. the W8 reference: a depth-cut fp32 Kosmos as in phase 5, quantized in the
   stacked layout, logits through the W8 kernels against
   ``set_w8_kernel("off")`` (bar 1e-3);
6c. the flagship W8 ``Kosmos.apply`` (phase 5's bf16 model quantized, the
   decoder stacked) at 2 x 1984 positions: finite logits, both W8 kernels
   and 24 flash launches per run, relative Frobenius error against the
   bf16 logits below 0.1, parameter bytes below 0.6 of the bf16 model's;
6d. phase 6's requests on the W8 model: ids in the vocabulary, two runs
   identical, all four kernels launched, times and peak memory beside
   phase 6's;
7. the flash backward kernels (dK/dV and dQ) against their plain versions on
   the same (o, l, m) at (2, 32, 2048, 64), the three cases of phase 3 in
   bf16 (bar 1e-2: P and dS round to bf16 as operands, and the readings on
   an H100 reached 6.0e-3) and fp32 (bar 1e-4, TF32 off), both relative to
   each gradient's largest reference value; two launches bit-identical;
8. the gradient reference: a full-width fp32 Kosmos cut to 2 decoder and 2
   ViT layers, one train step's loss and gradients (CLIP frozen) through
   the kernels with remat "dots" against the plain-attention path (bar 1e-3
   of each gradient's largest value);
9. the flagship training recipe of benchmarks/mm_train_probe.py: full
   Kosmos from a seeded init with fp32 parameters and bf16 compute, remat
   "dots", CLIP frozen, Lion, 8 steps of ``Trainer.run`` on one batch of
   2 x (1984 text + 64 image) positions: finite losses and gradient norms,
   the loss of step 8 below that of step 2, CLIP bit-identical, each
   backward kernel launched once per layer and step.

Every failed check raises. Before the last line it prints one JSON object
with each kernel's launches in its slice's run (generation for the forward
and decode kernels, W8 generation for the W8 kernels, training for the
backward kernels), its error and both times, then the card's ``nvidia-smi`` line; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import subprocess
import sys
import time

import torch

SEED = 0
FLASH_SHAPE = (2, 32, 2048, 64)
DECODE_B, DECODE_S = 8, 2048


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up
    long enough for the card to leave its idle clocks."""
    for _ in range(max(iters, 20)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def phase_flash(dev, fa):
    b, h, l, d = FLASH_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED)
    base = [torch.randn(FLASH_SHAPE, generator=g, device=dev) for _ in range(3)]
    seg = (torch.arange(l, device=dev)[None] <
           torch.tensor([l, 1500], device=dev)[:, None]).int() - 1
    cases = {
        "causal_xpos": dict(causal=True, xpos_scale_base=512),
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
            results[key] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                m_max_abs_err=max_err(m, m_ref),
                l_max_rel_err=((stat_l - l_ref).abs()
                               / l_ref.abs().clamp_min(1e-30)).max().item())
            log("flash", case=key, shape=list(FLASH_SHAPE), bar=bar,
                stats_bar="atol 1e-3, rtol 1e-4 (m) / 1e-3 (l)",
                **results[key])
            check(err < bar, f"flash {key} error {err} >= {bar}")
            check(stats_ok, f"flash {key} statistics (l, m) against the "
                            f"plain version")
            del o, o_ref, m, m_ref, stat_l, l_ref
    return results


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest error relative to the reference's largest magnitude."""
    return max_err(a, ref) / max(ref.float().abs().max().item(), 1e-30)


def phase_flash_bwd(dev, fa):
    """dK/dV and dQ kernels against their plain versions on the same
    residuals, with di = rowsum(o * do) computed once as the wrapper does."""
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
            o, stat_l, m = fa.flash_attention_fwd(q, k, v, **kw)
            di = fa._di(o, do)
            dk, dv = fa.flash_bwd_dkv(q, k, v, stat_l, m, di, do, **kw)
            dq = fa.flash_bwd_dq(q, k, v, stat_l, m, di, do, **kw)
            dk2, dv2 = fa.flash_bwd_dkv(q, k, v, stat_l, m, di, do, **kw)
            dq2 = fa.flash_bwd_dq(q, k, v, stat_l, m, di, do, **kw)
            ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, stat_l, m, di,
                                                    do, **kw)
            ref_dq = fa.flash_bwd_dq_plain(q, k, v, stat_l, m, di, do, **kw)
            torch.cuda.synchronize()
            errs = {n: (max_err(a, r), rel_err(a, r)) for n, a, r in
                    (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv))}
            same = (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                    and torch.equal(dv, dv2))
            args = (q, k, v, stat_l, m, di, do)
            key = f"{name}_{str(dtype).split('.')[-1]}"
            results[key] = dict(
                max_abs_err={n: e[0] for n, e in errs.items()},
                max_rel_err={n: e[1] for n, e in errs.items()},
                dkv_ms=cuda_ms(lambda: fa.flash_bwd_dkv(*args, **kw)),
                dq_ms=cuda_ms(lambda: fa.flash_bwd_dq(*args, **kw)),
                dkv_plain_ms=cuda_ms(lambda: fa.flash_bwd_dkv_plain(*args, **kw),
                                     iters=3),
                dq_plain_ms=cuda_ms(lambda: fa.flash_bwd_dq_plain(*args, **kw),
                                    iters=3),
                bit_identical=same)
            log("flash_bwd", case=key, shape=list(FLASH_SHAPE), rel_bar=bar,
                **results[key])
            for n, (_, rel) in errs.items():
                check(rel < bar, f"flash bwd {key} {n} relative error {rel} "
                                 f">= {bar}")
            check(same, f"flash bwd {key}: two launches differ")
            del o, stat_l, m, di, dq, dk, dv, dq2, dk2, dv2, ref_dq, ref_dk, ref_dv
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
    """Bars: the absolute ones of the kernel's contract (2e-2 bf16, 5e-2
    int8), and two that catch a kernel that drops or repeats a few cache
    positions: 1e-2 of each output row's magnitude, and 1e-5 absolute with
    an fp32 query, where nothing rounds to bf16."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = torch.randn(DECODE_B, 32, 1, 64, generator=g, device=dev) * 64 ** -0.5
    k = torch.randn(DECODE_B, 32, DECODE_S, 64, generator=g, device=dev)
    v = torch.randn(DECODE_B, 32, DECODE_S, 64, generator=g, device=dev)
    kv_len = torch.tensor([2048, 1999, 1500, 1024, 777, 512, 100, 1],
                          device=dev)
    (kq, ks), (vq, vs) = _quantize(k), _quantize(v)
    scales = dict(k_scale=ks, v_scale=vs)
    cases = {
        "bf16": ((q.bfloat16(), k.bfloat16(), v.bfloat16(), kv_len), {}, 2e-2),
        "int8": ((q.bfloat16(), kq, vq, kv_len), scales, 5e-2),
        "fp32": ((q, k, v, kv_len), {}, 1e-5),
        "int8_fp32_q": ((q, kq, vq, kv_len), scales, 1e-5),
    }
    results = {}
    for name, (args, kw, bar) in cases.items():
        o = da.decode_attention(*args, **kw)
        ref = da.decode_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err, rel = max_err(o, ref), row_rel_err(o, ref)
        results[name] = dict(
            max_abs_err=err, max_row_rel_err=rel,
            ms=cuda_ms(lambda: da.decode_attention(*args, **kw), 50),
            plain_ms=cuda_ms(lambda: da.decode_attention_plain(*args, **kw), 20))
        log("decode", case=name, q=[DECODE_B, 32, 1, 64],
            cache=[DECODE_B, 32, DECODE_S, 64], bar=bar, row_rel_bar=1e-2,
            **results[name])
        check(err < bar, f"decode {name} error {err} >= {bar}")
        check(rel < 1e-2, f"decode {name} row-relative error {rel} >= 1e-2")
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
        fa.flash_attention.launches = 0
        fwd_s = []
        for _ in range(runs):
            t0 = time.perf_counter()
            logits = model.apply(tokens, images)
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
    launches = fa.flash_attention.launches
    shape = tuple(logits.shape)
    finite = bool(torch.isfinite(logits).all())
    log("forward", params=n_params, init_s=init_s, forward_s=fwd_s,
        logits_shape=list(shape), finite=finite, flash_launches=launches)
    check(shape == (2, 1984, cfg.decoder.vocab_size), f"logits shape {shape}")
    check(finite, "flagship logits are finite")
    check(launches == runs * cfg.decoder.layers, f"flash launches {launches}")
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
    counts = (fa.flash_attention.launches, fa.flash_bwd_dkv.launches,
              fa.flash_bwd_dq.launches)
    (loss, _), grads = value_and_grad(kosmos_loss_fn(cfg), model, batch,
                                      freeze=("clip",))
    launches = [a - b for a, b in zip((fa.flash_attention.launches,
                                       fa.flash_bwd_dkv.launches,
                                       fa.flash_bwd_dq.launches), counts)]
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
        launches={"flash_fwd": launches[0], "flash_bwd_dkv": launches[1],
                  "flash_bwd_dq": launches[2]}, bar=1e-3)
    check(loss_err < 1e-3 * max(1.0, abs(ref_loss.item())),
          f"kernel vs plain path loss {loss.item()} vs {ref_loss.item()}")
    check(worst < 1e-3, f"kernel vs plain path gradient {worst_name}: {worst}")
    check(launches[1] == launches[2] == 2 and launches[0] == 4,
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
    fa.flash_attention.launches = 0
    fa.flash_bwd_dkv.launches = 0
    fa.flash_bwd_dq.launches = 0
    t0 = time.perf_counter()
    trainer.run(itertools.repeat(batch, TRAIN_STEPS), log_fn=log_fn)
    launches = {"flash_fwd": fa.flash_attention.launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
                "flash_bwd_dq": fa.flash_bwd_dq.launches}
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
        clip_bit_identical=clip_same)
    check(len(logs) == TRAIN_STEPS, f"{len(logs)} logged steps")
    check(all(math.isfinite(x) for x in losses + norms),
          "finite losses and gradient norms")
    check(losses[-1] < losses[1], f"loss of step 8 {losses[-1]} below step 2 "
                                  f"{losses[1]}")
    check(clip_same, "the frozen CLIP tower is bit-identical after training")
    layers = cfg.decoder.layers
    check(launches["flash_bwd_dkv"] == launches["flash_bwd_dq"]
          == layers * TRAIN_STEPS, f"backward kernel launches {launches}")
    check(launches["flash_fwd"] > 0, f"flash forward launches {launches}")
    return launches


def drive_generation(dev, model, cfg, kernels: dict) -> dict:
    """Greedy ``generate_multimodal`` with ``decode_attn_kernel=True`` for 4
    requests of one 224x224 image and 192/256/320/448 text tokens, 32 new
    tokens each: a first run with every counter of ``kernels`` (name ->
    wrapper) set to 0 just before and read just after, a second run for
    time and peak memory, and a prefill-only run."""
    from kosmosx_torch.generate.sampler import SamplingConfig, generate_multimodal

    gcfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, decode_attn_kernel=True))
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    lengths = torch.tensor([192, 256, 320, 448], device=dev)
    tokens = torch.randint(4, cfg.decoder.vocab_size, (4, 448), generator=g,
                           device=dev)
    tokens[torch.arange(448, device=dev)[None] >= lengths[:, None]] = \
        cfg.decoder.padding_idx
    images = pixels(4, g, dev)
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
    first, _ = run(new)
    launches = {name: fn.launches for name, fn in kernels.items()}
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


W8_DECODE_KN = ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 32002))
W8_SHAPES = ([(m, k, n) for m in (4, 8) for k, n in W8_DECODE_KN]
             + [(3968, 2048, 8192), (5, 130, 70), (514, 588, 1024)])
W8_STACK = (24, 2048, 8192)
W8_BARS = ((torch.float32, 1e-5), (torch.bfloat16, 1e-2))


def graph_ms(fn, calls: int = 10, replays: int = 5) -> float:
    """Device time of one ``fn`` call: ``calls`` calls captured in a CUDA
    graph, replayed, timed with CUDA events. At decode shapes a kernel is
    shorter than its Python wrapper, so back-to-back launches (``cuda_ms``)
    time the host; the graph leaves it out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def _w8_case(name, kernel, plain, bar, **shape) -> dict:
    """One W8 kernel case against its plain version: error relative to the
    reference's largest value, device times (graph) and back-to-back launch
    times (host-bound at decode shapes)."""
    y, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = rel_err(y, ref)
    result = dict(max_abs_err=max_err(y, ref), max_rel_err=err,
                  ms=graph_ms(kernel), plain_ms=graph_ms(plain),
                  launch_ms=cuda_ms(kernel), plain_launch_ms=cuda_ms(plain))
    log("w8_kernels", kernel=name, **shape, rel_bar=bar, **result)
    check(err < bar, f"{name} {shape} relative error {err} >= {bar}")
    return result


def phase_w8_kernels(dev, qm):
    """Both W8 kernels against ``w8_matmul_plain`` at the main path's shapes
    (decode M 4 and 8 over the decoder's and the vocab head's weights,
    prefill M 3968) and ragged ones, fp32 (TF32 off) and bf16."""
    from kosmosx_torch.utils.quantize import _quantize_w

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    results = {}
    for m, k, n in W8_SHAPES:
        w = _quantize_w(torch.randn(k, n, generator=g, device=dev) * 0.02)
        x = torch.randn(m, k, generator=g, device=dev)
        for dtype, bar in W8_BARS:
            xx = x.to(dtype)
            results[(m, k, n, dtype)] = _w8_case(
                "w8_matmul", lambda: qm.w8_matmul(xx, w["q"], w["scale"]),
                lambda: qm.w8_matmul_plain(xx, w["q"], w["scale"]), bar,
                m=m, k=k, n=n, dtype=str(dtype).split(".")[-1])
        del w
    w = _quantize_w(torch.randn(W8_STACK, generator=g, device=dev) * 0.02)
    for m in (4, 3968):
        x = torch.randn(m, W8_STACK[1], generator=g, device=dev)
        for dtype, bar in W8_BARS:
            xx = x.to(dtype)
            for li in (0, 11, 23):
                layer = torch.tensor(li, dtype=torch.int32, device=dev)
                results[("stacked", m, li, dtype)] = _w8_case(
                    "w8_matmul_stacked",
                    lambda: qm.w8_matmul_stacked(xx, w["q"], w["scale"], layer),
                    lambda: qm.w8_matmul_plain(xx, w["q"][li], w["scale"][li]),
                    bar, m=m, stack=list(W8_STACK), layer=li,
                    dtype=str(dtype).split(".")[-1])
    return results


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
        rel_frobenius_vs_bf16=rel, argmax_agreement=agree,
        param_bytes=w8_bytes, bf16_param_bytes=bf16_bytes,
        bytes_ratio=w8_bytes / bf16_bytes)
    layers = cfg.decoder.layers
    check(tuple(logits.shape) == (2, 1984, cfg.decoder.vocab_size),
          f"W8 logits shape {tuple(logits.shape)}")
    check(finite, "W8 flagship logits are finite")
    check(launches["flash"] == runs * layers, f"flash launches {launches}")
    check(launches["w8_matmul"] > 0 and launches["w8_matmul_stacked"]
          == runs * 6 * layers, f"W8 launches {launches}")
    check(rel < 0.1, f"W8 vs bf16 logits relative Frobenius error {rel}")
    check(w8_bytes < 0.6 * bf16_bytes, f"W8 bytes {w8_bytes} vs bf16 "
                                       f"{bf16_bytes}")
    del logits, ref
    return w8, w8_cfg


def phase_w8_generate(dev, fa, da, qm, w8, cfg, bf16):
    """Phase 6's requests on the W8 model, beside phase 6's bf16 run."""
    result = drive_generation(dev, w8, cfg, {
        "flash": fa.flash_attention, "decode": da.decode_attention,
        "w8_matmul": qm.w8_matmul, "w8_matmul_stacked": qm.w8_matmul_stacked})
    first = result.pop("tokens")
    launches = result["launches"]
    keys = ("prefill_s", "decode_step_ms", "tok_per_s", "peak_mem_bytes")
    log("w8_generate", **result, tokens_row0=first[0, :8].tolist(),
        bf16={k: bf16[k] for k in keys},
        token_agreement_vs_bf16=(first == bf16["tokens"]).float().mean().item())
    check(all(v > 0 for v in launches.values()),
          f"every kernel launched in W8 generation: {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import kosmosx_torch
    from kosmosx_torch.ops import _build
    from kosmosx_torch.ops import decode_attention as da
    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.ops import quant_matmul as qm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.library()
    build_log = (_build.build_dir() / "build.log").read_text().splitlines()
    log("build", seconds=time.perf_counter() - t0,
        sources=[f"kosmosx_torch/csrc/{n}" for n in _build.SOURCES],
        nvcc_flags=" ".join(_build.NVCC_FLAGS),
        library=str(_build.build_dir() / _build.LIB_NAME),
        ptxas=[ln.strip() for ln in build_log if "Used" in ln])

    flash = phase_flash(dev, fa)
    decode = phase_decode(dev, da)
    phase_reference(dev, kosmosx_torch)
    torch.cuda.empty_cache()
    model, cfg = phase_forward(dev, kosmosx_torch, fa)
    launches, bf16_gen = phase_generate(dev, kosmosx_torch, fa, da, model, cfg)
    w8k = phase_w8_kernels(dev, qm)
    torch.cuda.empty_cache()
    phase_w8_reference(dev, kosmosx_torch, qm)
    torch.cuda.empty_cache()
    w8, w8_cfg = phase_w8_forward(dev, kosmosx_torch, fa, qm, model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    w8_launches = phase_w8_generate(dev, fa, da, qm, w8, w8_cfg, bf16_gen)
    del w8
    gc.collect()
    torch.cuda.empty_cache()
    bwd = phase_flash_bwd(dev, fa)
    torch.cuda.empty_cache()
    phase_grad_reference(dev, kosmosx_torch, fa)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = phase_train(dev, kosmosx_torch, fa)

    main_flash = flash["causal_xpos_bfloat16"]
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "kosmosx_torch/csrc/flash_fwd.cu",
         "replaces": "kosmosx_tpu/ops/flash_attention.py:174",
         "launches": launches["flash"],
         "max_abs_err": max(r["max_abs_err"] for k, r in flash.items()
                            if k.endswith("bfloat16")),
         "ms": main_flash["ms"], "plain_ms": main_flash["plain_ms"]},
        {"name": "decode_attention", "route": "cuda",
         "source": "kosmosx_torch/csrc/decode_attention.cu",
         "replaces": "kosmosx_tpu/ops/decode_attention.py:77",
         "launches": launches["decode"],
         "max_abs_err": decode["bf16"]["max_abs_err"],
         "ms": decode["bf16"]["ms"], "plain_ms": decode["bf16"]["plain_ms"]},
    ]
    main_bwd = bwd["causal_xpos_bfloat16"]
    bf16_bwd = [r for k, r in bwd.items() if k.endswith("bfloat16")]
    for name, line, grads in (("flash_bwd_dkv", 348, ("dk", "dv")),
                              ("flash_bwd_dq", 411, ("dq",))):
        short = name.split("_")[-1]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "kosmosx_torch/csrc/flash_bwd.cu",
            "replaces": f"kosmosx_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[name],
            "max_abs_err": max(r["max_abs_err"][n] for r in bf16_bwd
                               for n in grads),
            "ms": main_bwd[f"{short}_ms"],
            "plain_ms": main_bwd[f"{short}_plain_ms"]})
    for name, line, main_case in (
            ("w8_matmul", 59, (4, 2048, 32002, torch.bfloat16)),
            ("w8_matmul_stacked", 156, ("stacked", 4, 11, torch.bfloat16))):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "kosmosx_torch/csrc/w8_matmul.cu",
            "replaces": f"kosmosx_tpu/ops/quant_matmul.py:{line}",
            "launches": w8_launches[name],
            "max_abs_err": max(r["max_abs_err"] for key, r in w8k.items()
                               if key[-1] == torch.bfloat16
                               and (key[0] == "stacked") == (name != "w8_matmul")),
            "ms": w8k[main_case]["ms"], "plain_ms": w8k[main_case]["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
