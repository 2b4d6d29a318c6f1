"""Window driver ``score``: offline multimodal scoring, ``Kosmos.apply``
under ``inference_mode`` on batches of text with one image a row, full
logits back.

Set-up makes the weights on the card in bfloat16 (quantized by the
program's own recipe where the configuration's weights are ``w8``) and runs
one forward at the window's shape. The window runs forwards on new inputs
drawn from the seed for ``--seconds``; the logits of one of them, chosen
by the seed, are kept. Compared with the float32 reference on the same
weights (its own int8 codes, worked out again from the same bfloat16
weights) over every row of that forward:

- ``logit_rel_rms``: the root mean square of the logits' gap over that of
  the reference's logits;
- ``logprob_gap``: the widest gap of a text target's log-probability.
"""

from __future__ import annotations

import time
from typing import Tuple

import torch

from perfbench import roofline, trace, weights
from perfbench.harness import Context, Outcome
from perfbench.window import Pacer, Readings, free, peak_bytes, sync


class Inputs:
    """The scoring batches of one stream of a seed, drawn on the device."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 stream: str = "inputs"):
        self.gen = weights.generator(device, seed, stream)
        self.shape = (traffic["batch"], traffic["text_len"])
        self.vocab = cfg["decoder"]["vocab_size"]
        self.size = cfg["vision"]["image_size"]
        self.device = device

    def next(self) -> Tuple[torch.Tensor, torch.Tensor]:
        toks = weights.tokens(self.gen, self.shape, self.vocab, self.device)
        return toks, weights.pixels(self.gen, self.shape[0], self.size,
                                    self.device)


def run(ctx: Context) -> Outcome:
    from perfbench import port

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    kcfg = port.kosmos_config(cfg)
    model = port.build_model(kcfg, weights.make_weights(
        cfg, ctx.seed, dev, torch.bfloat16))
    free(dev)
    with torch.inference_mode():
        model.apply(*Inputs(cfg, tr, ctx.seed, dev, "warmup").next())
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    inputs = Inputs(cfg, tr, ctx.seed, dev)
    keep = weights.mix(ctx.seed, "kept") % tr["keep_among"]
    kept = last = None
    n = 0
    pacer = Pacer(dev, ctx.seconds)
    with torch.inference_mode():
        while pacer.more():
            toks, imgs = inputs.next()
            out = model.apply(toks, imgs)
            if ctx.faults.get("alter_answer"):
                mid = out.shape[1] // 2   # the planted fault
                out[0, mid] = out[0, mid + 1]
            last = (toks, imgs, out)
            if n == keep:
                kept = last
            n += 1
    window_s = pacer.close()
    peak = peak_bytes(dev)
    kept = kept or last
    length = tr["text_len"] + cfg["image_embed_len"]
    fwd_flops = tr["batch"] * roofline.sequence_flops(cfg, length, 1)

    readings = None
    if ctx.trace:
        readings = Readings(window_s, n, n * fwd_flops)
        spans = trace.Spans()
        trace.install(spans)
        spans.phase(model, "apply", "Kosmos.apply")
        before = trace.launch_counts(spans)
        with trace.profiled([trace.FLASH_FWD, trace.W8, trace.W8_STACKED,
                             "Kosmos.apply"], dev) as box:
            with torch.inference_mode():
                for _ in range(tr["profile_steps"]):
                    model.apply(*inputs.next())
        trace.check_spans(spans, before, dev)
        spans.remove()
        readings.profile = box["profile"]
        readings.profile_steps = tr["profile_steps"]
        readings.calls = spans.calls

    del model, last
    free(dev)
    compared = compare(ctx, *kept)
    return Outcome(attempted=n, failed=0,
                   e2e={"score_tokens_per_s": n * tr["batch"] * length
                        / window_s, "setup_s": setup_s},
                   compared=compared, memory_peak_bytes=peak,
                   readings=readings)


def control(ctx: Context, precisions) -> dict:
    """The controls' readings: the reference at each of ``precisions`` in
    the program's place, on a batch drawn from the seed."""
    toks, imgs = Inputs(ctx.cell.config, ctx.cell.traffic, ctx.seed,
                        ctx.device).next()
    return {f"control:{p}": compare(ctx, toks, imgs, None, control=p)
            for p in precisions}


def text_logprobs(logits: torch.Tensor, tokens: torch.Tensor,
                  cfg: dict) -> torch.Tensor:
    """Log-probabilities of each next text token (1, Lt - 1) from one
    row's logits: the image block's and the ``<image>`` token's logits
    predict no text."""
    s, k = cfg["splice_index"], cfg["image_embed_len"]
    text = torch.cat([logits[:, :s - 1], logits[:, s + k - 1:]], dim=1)
    logp = torch.log_softmax(text[:, :-1].float(), dim=-1)
    return torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]


def compare(ctx: Context, toks, imgs, got, *, control: str = None) -> dict:
    """The rows ``got(r)`` (a forward's logits, row by row) against the
    reference's on the same weights, at the configuration's precision;
    ``got`` may be a tensor (the program's logits). ``control``: a
    precision of the reference to put in the program's place."""
    from perfbench.reference import kosmos as ref

    cfg, dev = ctx.cell.config, ctx.device
    ref.strict_fp32()
    flat = weights.make_weights(cfg, ctx.seed, dev, torch.bfloat16)
    at = "w8" if cfg["weights"] == "w8" else "fp32"
    p = ref.prepare(flat, at,
                    cfg["decoder"]["layers"])
    if control is not None:
        pc, lin_c = ref.prepare(flat, control,
                    cfg["decoder"]["layers"]), ref.Lin(control)
        got = lambda r: ref.logits(pc, cfg, toks[r:r + 1],  # noqa: E731
                                   imgs[r:r + 1], lin_c)
    elif isinstance(got, torch.Tensor):
        out = got
        got = lambda r: out[r:r + 1].float()  # noqa: E731
    del flat
    lin = ref.Lin()
    gap2 = norm2 = 0.0
    lp_gap = 0.0
    with torch.no_grad():
        for r in range(toks.shape[0]):
            want = ref.logits(p, cfg, toks[r:r + 1], imgs[r:r + 1], lin)
            have = got(r)
            gap2 += float((have - want).square().sum())
            norm2 += float(want.square().sum())
            lp = (text_logprobs(have, toks[r:r + 1], cfg)
                  - text_logprobs(want, toks[r:r + 1], cfg)).abs().max()
            lp_gap = max(lp_gap, float(lp))
            del want, have
    del p
    free(dev)
    return {"logit_rel_rms": (gap2 / norm2) ** 0.5, "logprob_gap": lp_gap}
