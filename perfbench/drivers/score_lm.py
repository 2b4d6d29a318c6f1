"""Window driver ``score_lm``: offline long-document scoring with a
text-only LM, ``Lfm2.apply`` under ``inference_mode`` on batches of
``batch`` rows of ``length`` token ids (one document a row, no padding),
full logits back.

Set-up makes the weights on the card in bfloat16 (``perfbench/
weights_lfm2.py``) and runs one forward at the window's shape. The window
runs forwards on new ids drawn from the seed (Zipf's law with the traffic's
exponent over the vocabulary) for ``--seconds``; the logits of one of the
first ``keep_among``, chosen by the seed, are kept. Compared after the
window with the float32 reference (``perfbench/reference/lfm2.py``) on the
same weights over every row of that forward:

- ``logit_rel_rms``: the root mean square of the logits' gap over that of
  the reference's logits;
- ``logprob_gap``: the widest gap of a next token's log-probability
  (printed, and compared only where the limits file gives it a limit: on
  this model one flipped expert choice sets it, and the fp8 control reads
  barely above the program).

Planted faults (``perfbench/controls.py --faults``): ``ignore_bias`` (the
experts chosen by the router's sigmoids alone: the expert bias zeroed),
``conv_shift`` (the conv taps applied one position later, so a position
sees the next one's B x~), ``kv_mod`` (query head h reads key/value head
h % Hkv in place of h // (H / Hkv)).
"""

from __future__ import annotations

import contextlib
import functools
import json
import sys
import time

import torch

from perfbench import roofline_lfm2, trace, weights, weights_lfm2
from perfbench.harness import Context, Outcome
from perfbench.window import Pacer, Readings, free, peak_bytes, sync

# the configuration file's keys that are the port's Lfm2Config fields, and
# those the port takes at one value only
_CONFIG_KEYS = ("vocab_size", "hidden_size", "intermediate_size",
                "moe_intermediate_size", "num_attention_heads",
                "num_key_value_heads", "norm_eps", "num_dense_layers",
                "num_experts", "num_experts_per_tok", "routed_scaling_factor",
                "compute_dtype")
_FIXED = {"conv_L_cache": 3, "conv_bias": False, "norm_topk_prob": True,
          "use_expert_bias": True, "tie_embedding": True}


def lfm2_config(cfg: dict):
    """The port's ``Lfm2Config`` for a configuration file; raises where the
    file asks for what the port does not run."""
    from kosmosx_torch.core.config import Lfm2Config

    other = {k: cfg[k] for k, v in _FIXED.items() if cfg[k] != v}
    if other or len(cfg["layer_types"]) != cfg["num_hidden_layers"]:
        raise ValueError(f"the port runs {_FIXED} and num_hidden_layers "
                         f"layer_types; the configuration has {other}")
    return Lfm2Config(**{k: cfg[k] for k in _CONFIG_KEYS},
                      layer_types=tuple(cfg["layer_types"]),
                      rope_theta=float(cfg["rope_parameters"]["rope_theta"]))


class Inputs:
    """The scoring batches of one stream of a seed, drawn on the device."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 stream: str = "inputs"):
        self.gen = weights.generator(device, seed, stream)
        self.shape = (traffic["batch"], traffic["length"])
        self.cdf = weights_lfm2.zipf_cdf(cfg["vocab_size"],
                                         traffic["zipf_s"], device)

    def next(self) -> torch.Tensor:
        return weights_lfm2.zipf_tokens(self.gen, self.cdf, self.shape)


@contextlib.contextmanager
def planted(ctx: Context, model):
    """The planted faults of ``ctx.faults`` in place while the block runs
    (the window's forwards), undone after."""
    undo = []
    if ctx.faults.get("ignore_bias"):
        for layer in model["layers"]:
            if "moe" in layer:
                bias = layer["moe"]["expert_bias"]
                kept = bias.detach().clone()
                bias.data.zero_()
                undo.append(lambda b=bias, k=kept: b.data.copy_(k))
    if ctx.faults.get("conv_shift"):
        from kosmosx_torch.ops import short_conv as sc

        original = sc.short_conv

        @functools.wraps(original)   # carries its launch counter along
        def shifted(bcx, taps, seq_len):
            d = bcx.shape[1] // 3
            moved = bcx.clone()
            moved[:-1, :d] = bcx[1:, :d]            # B of the next position
            moved[:-1, 2 * d:] = bcx[1:, 2 * d:]    # x~ of the next position
            return original(moved, taps, seq_len)

        sc.short_conv = shifted
        undo.append(lambda: setattr(sc, "short_conv", original))
    if ctx.faults.get("kv_mod"):
        from kosmosx_torch.ops import flash_attention as fa

        original_fwd = fa.flash_attention_fwd

        @functools.wraps(original_fwd)
        def mod_heads(q, k, v, **kw):
            idx = torch.arange(q.shape[1], device=q.device) % k.shape[1]
            return original_fwd(q, k[:, idx].contiguous(),
                                v[:, idx].contiguous(), **kw)

        fa.flash_attention_fwd = mod_heads
        undo.append(lambda: setattr(fa, "flash_attention_fwd", original_fwd))
    try:
        yield
    finally:
        for fn in reversed(undo):
            fn()


def build(cfg: dict, seed: int, device):
    """The program's model over the seed's weights, and the weights
    (``{dotted path: tensor}``, shared with the model)."""
    from kosmosx_torch.models.lfm2 import Lfm2

    from perfbench.reference.lfm2 import nest

    flat = weights_lfm2.make_weights(cfg, seed, device, torch.bfloat16)
    return Lfm2(lfm2_config(cfg), params=nest(flat)), flat


def run(ctx: Context) -> Outcome:
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    model, flat = build(cfg, ctx.seed, dev)
    free(dev)
    with torch.inference_mode():
        model.apply(Inputs(cfg, tr, ctx.seed, dev, "warmup").next())
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    inputs = Inputs(cfg, tr, ctx.seed, dev)
    keep = weights.mix(ctx.seed, "kept") % tr["keep_among"]
    kept = last = None
    n = 0
    with planted(ctx, model):
        pacer = Pacer(dev, ctx.seconds)
        with torch.inference_mode():
            while pacer.more():
                toks = inputs.next()
                out = model.apply(toks)
                last = (toks, out)
                if n == keep:
                    kept = last
                n += 1
        window_s = pacer.close()
    peak = peak_bytes(dev)
    kept = kept or last
    positions = tr["batch"] * tr["length"]
    fwd_flops = roofline_lfm2.forward_flops(cfg, tr["batch"], tr["length"])

    readings = None
    if ctx.trace:
        readings = Readings(window_s, n, n * fwd_flops)
        spans = trace.Spans()
        spans.phase(model, "apply", "Lfm2.apply")
        with trace.profiled(["Lfm2.apply"], dev) as box:
            with torch.inference_mode():
                for _ in range(tr["profile_steps"]):
                    model.apply(inputs.next())
        spans.remove()
        readings.profile = box["profile"]
        readings.profile_steps = tr["profile_steps"]

    del model, last
    free(dev)
    gaps = compare(ctx, flat, kept[0], kept[1])
    print("score_lm: " + json.dumps(gaps), file=sys.stderr)
    compared = {k: v for k, v in gaps.items() if k in ctx.cell.limits}
    return Outcome(attempted=n, failed=0,
                   e2e={"score_tokens_per_s": n * positions / window_s,
                        "setup_s": setup_s},
                   compared=compared, memory_peak_bytes=peak,
                   readings=readings)


def control(ctx: Context, precisions) -> dict:
    """The controls' readings: the reference at each of ``precisions`` in
    the program's place, on a batch drawn from the seed."""
    cfg, dev = ctx.cell.config, ctx.device
    flat = weights_lfm2.make_weights(cfg, ctx.seed, dev, torch.bfloat16)
    toks = Inputs(cfg, ctx.cell.traffic, ctx.seed, dev).next()
    out = {f"control:{p}": compare(ctx, flat, toks, None, control=p)
           for p in precisions}
    del flat
    free(dev)
    return out


def compare(ctx: Context, flat, toks, got, *, control: str = None) -> dict:
    """The program's logits ``got`` (B, L, V) against the reference's on
    the same weights, row by row; ``control``: a precision of the
    reference to put in the program's place."""
    from perfbench.reference import lfm2 as ref

    cfg, dev = ctx.cell.config, ctx.device
    ref.strict_fp32()
    lin = ref.Lin()
    gap2 = norm2 = 0.0
    lp_gap = 0.0
    with torch.no_grad():
        x = ref.hidden(flat, cfg, toks, lin)
        x_c = None if control is None else ref.hidden(flat, cfg, toks,
                                                      ref.Lin(control))
        for r in range(toks.shape[0]):
            want = ref.row_logits(flat, cfg, x[r], lin)
            if x_c is None:
                have = got[r].float()
            else:
                have = ref.row_logits(flat, cfg, x_c[r], ref.Lin(control))
            gap2 += float((have - want).square().sum())
            norm2 += float(want.square().sum())
            lp = (ref.logprobs(have, toks[r])
                  - ref.logprobs(want, toks[r])).abs().max()
            lp_gap = max(lp_gap, float(lp))
            del want, have
    del x, x_c
    free(dev)
    return {"logit_rel_rms": (gap2 / norm2) ** 0.5, "logprob_gap": lp_gap}
