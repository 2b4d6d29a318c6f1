"""Window driver ``serve``: the port's ``ServeEngine`` under a closed loop
of clients, greedy decoding.

Set-up makes the weights on the card in bfloat16, builds the engine, runs
its ``warmup`` (every admission path once: a batched group, a batch-1 text
and a multimodal prefill, the decode step over the pool) and fills every
slot with a client's first request. In the window each client sends its
next request as soon as its last one completes; ``step()`` is called in a
loop, and after each call the tokens each request has committed are
stamped with the host clock. After the window the engine keeps stepping,
with no new request, until every request sent in the window has its first
token (for a minute at most: one that has none by then failed).

Compared with the float32 reference: a sample of finished requests drawn
from the seed, the longest among them, each run once through the reference
over its prompt and served tokens. At each served token, the gap by which
its logit lies below the reference's best at its position;
``mean_token_gap`` is their mean. (Their widest, ``widest_token_gap``, is
printed beside it: it does not separate the program from its control, see
``PERF.md``.)
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import List

import numpy as np
import torch

from perfbench import roofline, trace, weights
from perfbench.harness import Context, Outcome, percentile
from perfbench.traffic import Stream
from perfbench.window import Readings, free, peak_bytes, sync

_LATE_S = 60.0


class Client:
    """One request in flight: what was sent and when each token came."""

    def __init__(self, req, handle, sent: float):
        self.req, self.handle, self.sent = req, handle, sent
        self.times: List[float] = []


class Loop:
    """The closed loop over the engine: clients, stamps and counters."""

    def __init__(self, eng, stream: Stream, clients: int):
        self.eng, self.stream = eng, stream
        self.live: List[Client] = []
        self.done: List[Client] = []
        self.clients = clients

    def send(self, now: float, budget=None) -> Client:
        r = self.stream.next()
        if budget is not None:
            r.new_tokens = budget(r.new_tokens)
        h = self.eng.submit(r.prompt, max_new_tokens=r.new_tokens,
                            images=r.images)
        c = Client(r, h, now)
        self.live.append(c)
        return c

    def step(self, resend: bool) -> float:
        """One engine step; stamps new tokens; finished clients send
        again where ``resend``. Returns the time of the stamps."""
        self.eng.step()
        now = time.perf_counter()
        still = []
        for c in self.live:
            c.times.extend([now] * (len(c.handle.tokens) - len(c.times)))
            if c.handle.done:
                self.done.append(c)
            else:
                still.append(c)
        self.live = still
        if resend:
            while len(self.live) < self.clients:
                self.send(now)
        return now


def run(ctx: Context) -> Outcome:
    from kosmosx_torch.generate.sampler import SamplingConfig
    from kosmosx_torch.serve import engine as engine_mod
    from kosmosx_torch.serve.config import ServeConfig

    from perfbench import port

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    kcfg = port.kosmos_config(cfg, decode_attn_kernel=tr["decode_attn_kernel"])
    model = port.build_model(kcfg, weights.make_weights(
        cfg, ctx.seed, dev, torch.bfloat16))
    free(dev)
    undo = plant(ctx, engine_mod)
    eng = engine_mod.ServeEngine(
        model, kcfg.decoder,
        ServeConfig(max_batch=tr["max_batch"],
                    max_prompt_len=tr["max_prompt_len"],
                    max_len=tr["max_len"]),
        SamplingConfig(greedy=True), kosmos_cfg=kcfg,
        generator=weights.generator(dev, ctx.seed, "sampling"), device=dev)
    eng.warmup(images=weights.pixels(weights.generator(dev, ctx.seed, "warm"),
                                     1, cfg["vision"]["image_size"], dev))
    loop = Loop(eng, Stream(tr, cfg, ctx.seed, dev), tr["clients"])
    # the first requests are cut to a remaining budget, uniform below their
    # own, as if each client had been sending for a while: completions are
    # spread from the window's start instead of coming in one wave
    rest = np.random.RandomState(weights.mix(ctx.seed, "rest") % 2 ** 32)
    for _ in range(tr["clients"]):
        loop.send(time.perf_counter(), lambda n: 1 + int(rest.randint(n)))
    while eng.pending:
        loop.step(resend=True)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    admitted = lambda: eng._next_id - len(eng.pending)  # noqa: E731
    start = {"phase": dict(eng.phase_s), "steps": eng.steps,
             "admitted": admitted()}
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    now = t0
    steps = 0
    while now < t_end:
        now = loop.step(resend=True)
        steps += 1
    window_s = now - t0
    end = {"phase": dict(eng.phase_s), "steps": eng.steps,
           "admitted": admitted()}
    print(f"serve: {steps} steps in {window_s:.3f} s, "
          f"{end['admitted'] - start['admitted']} admitted, phase_s "
          + json.dumps({k: round(end['phase'][k] - start['phase'][k], 4)
                        for k in end['phase']}), file=sys.stderr)
    sent = [c for c in loop.live + loop.done if c.sent >= t0]
    late = time.perf_counter() + _LATE_S
    while any(not c.times for c in sent) and time.perf_counter() < late:
        loop.step(resend=False)
    peak = peak_bytes(dev)

    everyone = loop.live + loop.done
    stamps = [t for c in everyone for t in c.times if t0 <= t <= now]
    ttft = [(c.times[0] - c.sent) * 1e3 if c.times else math.inf
            for c in sent]
    gaps = [(b - a) * 1e3 for c in everyone
            for a, b in zip(c.times, c.times[1:]) if t0 <= a and b <= now]
    failed = sum(not c.times for c in sent)

    readings = None
    if ctx.trace:
        readings = Readings(window_s, steps,
                            window_flops(cfg, everyone, t0, now))
        readings.engine = {
            "dispatch_ms": 1e3 * (end["phase"]["dispatch"]
                                  - start["phase"]["dispatch"])
            / max(end["steps"] - start["steps"], 1),
            "admit_ms": 1e3 * (end["phase"]["admit"] - start["phase"]["admit"])
            / (end["admitted"] - start["admitted"])
            if end["admitted"] > start["admitted"] else None,
            "itl_p95_ms": percentile(gaps, 95) if gaps else None,
            "ttft_p95_ms": percentile(ttft, 95) if ttft else None}
        profile(ctx, loop, readings)

    sample = choose(ctx, [c for c in loop.done if len(c.handle.tokens)
                          == c.req.new_tokens])
    del eng, loop, model
    undo()
    free(dev)
    gaps = token_gaps(ctx, sample)
    print("serve: " + json.dumps(gaps), file=sys.stderr)
    compared = {k: v for k, v in gaps.items() if k in ctx.cell.limits}
    return Outcome(attempted=len(sent), failed=failed,
                   e2e={"serve_tokens_per_s": len(stamps) / window_s,
                        "setup_s": setup_s},
                   compared=compared, memory_peak_bytes=peak,
                   readings=readings, extras={"sample": sample})


def control(ctx: Context, precisions) -> dict:
    """The controls' readings on a run's sample: the reference at each of
    ``precisions`` in the program's place; and the run's own numbers."""
    out = run(ctx)
    got = {"program": token_gaps(ctx, out.extras["sample"])}
    for p in precisions:
        got[f"control:{p}"] = token_gaps(ctx, out.extras["sample"], p)
    return got


def plant(ctx: Context, engine_mod):
    """The planted fault of a test: every decode step emits, in every row,
    the next id over from the one it chose. Returns the undo."""
    if not ctx.faults.get("alter_token"):
        return lambda: None
    real = engine_mod._decode_core

    def altered(*args, **kwargs):
        nxt, nlp, index = real(*args, **kwargs)
        return (nxt + 1) % ctx.cell.config["decoder"]["vocab_size"], nlp, \
            index

    engine_mod._decode_core = altered
    return lambda: setattr(engine_mod, "_decode_core", real)


def window_flops(cfg: dict, clients, t0: float, t1: float) -> float:
    """Model FLOPs of the work committed in the window: the prefill of each
    request whose first token came in it (its real prompt and image, the
    head at its last position), and a decode step for each later token."""
    img = cfg["image_embed_len"]
    total = 0.0
    for c in clients:
        length = len(c.req.prompt) + (img if c.req.images is not None else 0)
        for k, t in enumerate(c.times):
            if not t0 <= t <= t1:
                continue
            if k == 0:
                total += roofline.sequence_flops(
                    cfg, length, int(c.req.images is not None),
                    head_positions=1)
            else:
                total += roofline.decode_token_flops(cfg, length + k - 1)
    return total


def profile(ctx: Context, loop: Loop, readings: Readings) -> None:
    """Profile ``profile_steps`` more steps of the loop (clients still
    sending) under the entry points' spans."""
    from kosmosx_torch.serve.engine import ServeEngine

    spans = trace.Spans()
    trace.install(spans)
    for attr in ("_admit", "_admit_many", "_dispatch", "_collect_done"):
        spans.phase(ServeEngine, attr, f"ServeEngine.{attr}")
    labels = [trace.FLASH_FWD, trace.DECODE] + \
        [f"ServeEngine.{a}" for a in ("_admit", "_admit_many", "_dispatch",
                                      "_collect_done")]
    before = trace.launch_counts(spans)
    n = ctx.cell.traffic["profile_steps"]
    with trace.profiled(labels, ctx.device) as box:
        for _ in range(n):
            loop.step(resend=True)
    trace.check_spans(spans, before, ctx.device)
    spans.remove()
    readings.profile = box["profile"]
    readings.profile_steps = n
    readings.calls = spans.calls


def choose(ctx: Context, finished: List[Client]) -> List[Client]:
    """The seed's sample of finished requests, the longest among them."""
    n = ctx.cell.traffic["check_requests"]
    if not finished:
        return []
    longest = max(finished, key=lambda c: len(c.req.prompt)
                  + len(c.handle.tokens))
    rest = [c for c in finished if c is not longest]
    rng = np.random.RandomState(weights.mix(ctx.seed, "sample") % 2 ** 32)
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def token_gaps(ctx: Context, sample: List[Client], control: str = None
               ) -> dict:
    """Over the served tokens of ``sample``, the gaps by which each token's
    reference logit lies below the reference's best at its position (with
    ``control``: the token that precision puts first): their mean and
    their widest. No sample (nothing finished) reads infinite."""
    from perfbench.reference import kosmos as ref

    if not sample:
        return {"mean_token_gap": math.inf, "widest_token_gap": math.inf}
    cfg, dev = ctx.cell.config, ctx.device
    ref.strict_fp32()
    flat = weights.make_weights(cfg, ctx.seed, dev, torch.bfloat16)
    p = ref.prepare(flat, "fp32", cfg["decoder"]["layers"])
    pc = ref.prepare(flat, control, cfg["decoder"]["layers"]) \
        if control else None
    del flat
    lin, lin_c = ref.Lin(), ref.Lin(control or "fp32")
    gaps = []
    with torch.no_grad():
        for c in sample:
            served = list(c.handle.tokens)
            toks = torch.tensor([c.req.prompt + served[:-1]], device=dev)
            img = c.req.images
            first = len(c.req.prompt) - 1 + (
                cfg["image_embed_len"] if img is not None else 0)
            want = ref.logits(p, cfg, toks, img, lin)[0, first:]
            if control:
                have = ref.logits(pc, cfg, toks, img, lin_c)[0, first:]
                chosen = have.argmax(-1)
            else:
                chosen = torch.tensor(served, device=dev)
            best = want.max(-1).values
            gaps.append(best - want.gather(-1, chosen[:, None])[:, 0])
            del want
    del p, pc
    free(dev)
    gaps = torch.cat(gaps)
    return {"mean_token_gap": float(gaps.mean()),
            "widest_token_gap": float(gaps.max())}
