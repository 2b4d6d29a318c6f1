"""The port's spans (``kosmosx_torch/utils/trace.py``) and the benchmark's
per-layer metrics that read them, on the CPU; one ``cuda`` test times
``device=True`` spans on the card.

The facility: nothing at all while tracing is off (no record, no CUDA
event, no profiler range), parents and threads, the clock shared with
``torch.profiler``, the Chrome export and the bounded buffer. The program's
spans: one serving request's id on its submit, admission, prefill and
commits (and the engine's prefill counters against them), a training
loop's and a forward's spans, the ops' shapes as the benchmark's wrappers
record them. The readers: hand-built profiles where every number is known,
and the tiny CPU mixes of ``perfbench/tests/perfbench_tiny.py``.
This file imports no jax.
"""

import collections
import itertools
import json
import pathlib
import statistics
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import kosmosx_torch.core.config as tcfg
from kosmosx_torch.generate.sampler import SamplingConfig
from kosmosx_torch.models.language import KosmosLanguage
from kosmosx_torch.ops import decode_attention as tdec
from kosmosx_torch.ops import flash_attention as tfa
from kosmosx_torch.ops import quant_matmul as tqm
from kosmosx_torch.serve import ServeConfig, ServeEngine
from kosmosx_torch.utils import trace
from perfbench import harness
from perfbench import trace as ptrace
from perfbench.layer_metrics import _spans
from perfbench.tests import perfbench_tiny
from perfbench.window import Readings

CFG = tcfg.MagnetoConfig(vocab_size=97, embed_dim=64, ffn_dim=128, layers=2,
                         heads=4, max_positions=128, use_flash_attention=False,
                         multiway=False, dropout=0.0, attention_dropout=0.0,
                         scan_layers=True, compute_dtype="float32")


@pytest.fixture(autouse=True)
def fresh_buffer():
    trace.clear()
    yield
    trace.clear()


def names(records):
    return [r.name for r in records]


def committed(r):
    """{request id: tokens} of a ``serve.commit`` record: a drained
    entry's lists, or one request's commit."""
    if "requests" in r.attrs:
        return dict(zip(r.attrs["requests"], r.attrs["tokens"]))
    return {r.attrs["request"]: r.attrs["tokens"]}


# -- the facility --------------------------------------------------------------


def test_off_records_nothing(monkeypatch):
    """With tracing off a span is the shared no-op: no record, no CUDA
    event, no profiler range, even with ``device=True``."""
    def refuse(*a, **k):
        raise AssertionError("created while tracing is off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(trace, "_Range", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert trace.span("x") is trace.OFF
    with trace.span("a", device=True, x=1) as sp:
        assert sp is trace.OFF and not sp.on
        sp.set(y=2)
        trace.instant("b")
    x = torch.randn(2, 4, 64)
    q, scale = torch.randint(-127, 128, (64, 32), dtype=torch.int8), \
        torch.rand(32)
    tqm.w8_matmul(x, q, scale)
    assert trace.records() == [] and trace.dropped() == 0


def test_nesting_parents_and_threads():
    """A span's parent is the span open on its own thread; another thread
    starts at the top; an instant takes the open span as its parent."""
    seen = {}

    def other():
        with trace.span("other") as sp:
            seen["other"] = sp

    with trace.enable():
        assert trace.span("x") is not trace.OFF
        with trace.span("outer", k=1) as outer:
            with trace.span("inner") as inner:
                trace.instant("mark", n=3)
                t = threading.Thread(target=other)
                t.start()
                t.join(10)
            inner.set(late=True)
    assert not t.is_alive() and trace.span("x") is trace.OFF
    by = {r.name: r for r in trace.records()}
    assert set(by) == {"outer", "inner", "mark", "other"}
    assert by["outer"].parent == 0 and by["inner"].parent == outer.id
    assert by["mark"].parent == inner.id and by["mark"].start == \
        by["mark"].end
    assert by["other"].parent == 0
    assert by["other"].thread != by["outer"].thread == \
        threading.get_native_id()
    assert by["inner"].attrs == {"late": True}
    assert by["outer"].start <= by["inner"].start <= by["inner"].end \
        <= by["outer"].end


def test_spans_share_the_profilers_clock():
    """Under a CPU ``torch.profiler`` every span records (tracing on with
    no ``enable``) and opens a range of its name; each span's start lies
    within 20 µs of the profiler's record of the same span at the median
    and 100 µs at the 95th percentile, over 1,000 spans."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(1000):
            with trace.span("clock.check", i=i):
                pass
    ours = sorted((r for r in trace.records() if r.name == "clock.check"),
                  key=lambda r: r.start)
    theirs = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "clock.check"),
                    key=lambda e: e.start_ns())
    assert len(ours) == len(theirs) == 1000
    gaps = sorted(abs(e.start_ns() - r.start) / 1e3
                  for r, e in zip(ours, theirs))
    assert statistics.median(gaps) < 20 and gaps[949] < 100
    # a function-scope range: the profiler draws no device-side copy
    assert not any(e.is_user_annotation() for e in theirs)


def test_write_chrome_keeps_ids(tmp_path):
    """The Chrome JSON parses, and keeps every span's id, parent, thread
    and attributes, at µs on the Unix clock."""
    with trace.enable():
        with trace.span("a", request=7):
            with trace.span("b"):
                trace.instant("c")
    recs = {r.name: r for r in trace.records()}
    n = trace.write_chrome(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert n == 3 and doc["baseTimeNanoseconds"] == 0
    assert doc["otherData"]["dropped"] == 0
    assert ev["a"]["ph"] == "X" and ev["c"]["ph"] == "i"
    for name, r in recs.items():   # a double holds Unix µs to 0.25 µs
        assert abs(ev[name]["ts"] - r.start / 1e3) <= 0.25
    assert ev["a"]["dur"] == pytest.approx((recs["a"].end - recs["a"].start)
                                           / 1e3)
    assert ev["a"]["args"]["request"] == 7
    for name, r in recs.items():
        assert ev[name]["args"]["id"] == r.id
        assert ev[name]["args"]["parent"] == r.parent
        assert ev[name]["tid"] == r.thread
    assert ev["b"]["args"]["parent"] == ev["a"]["args"]["id"]


def test_buffer_keeps_the_newest_and_counts_drops(monkeypatch):
    """The buffer holds its capacity's newest records and counts the rest
    as dropped; ``clear`` empties it and zeroes the count."""
    assert trace._buffer.maxlen == 1 << 17
    monkeypatch.setattr(trace, "_buffer", collections.deque(maxlen=5))
    with trace.enable():
        for i in range(8):
            with trace.span("s", i=i):
                pass
    assert trace.dropped() == 3
    assert [r.attrs["i"] for r in trace.records()] == [3, 4, 5, 6, 7]
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


# -- the program's spans -------------------------------------------------------


def tiny_engine(max_batch=4, **scfg):
    """A 2-layer text engine on the CPU; 4 slots batch-admit groups of 4."""
    model = KosmosLanguage(CFG, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    return ServeEngine(model, CFG,
                       ServeConfig(max_batch=max_batch, max_prompt_len=16,
                                   max_len=64, **scfg),
                       SamplingConfig(greedy=True), device="cpu")


@pytest.mark.parametrize("drain", [dict(), dict(sync_lag=0,
                                                 async_drain=False)],
                         ids=["async", "latency"])
def test_request_id_across_its_spans(drain):
    """One request's id on its ``serve.submit``, ``serve.admit``,
    ``serve.prefill`` (inside the admission) and ``serve.commit`` spans
    (one a drained entry, listing its requests), the commits' tokens
    summing to what it got; every span under its ``serve.step``; the
    prefill counters equal to the spans' numbers; a latency engine's reads
    of the first token in ``serve.wait``."""
    eng = tiny_engine(**drain)
    with trace.enable():
        hs = [eng.submit([5, 6, 7], max_new_tokens=4),
              eng.submit([8, 9], max_new_tokens=3)]
        steps = eng.run()
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    assert names(recs).count("serve.step") == steps
    for h in hs:
        mine = [r for r in recs if r.attrs.get("request") == h.id]
        kinds = names(mine)
        assert kinds[0] == "serve.submit"
        assert {"serve.admit", "serve.prefill"} <= set(kinds)
        commits = [committed(r) for r in recs if r.name == "serve.commit"]
        assert sum(c.get(h.id, 0) for c in commits) == len(h.tokens)
        prefill = next(r for r in mine if r.name == "serve.prefill")
        admit = by_id[prefill.parent]
        assert admit.name == "serve.admit" and admit.attrs["request"] == h.id
        assert admit.attrs["path"] == "single"
        assert by_id[admit.parent].name == "serve.step"
        assert prefill.attrs["real"] == len(h.prompt)
        assert prefill.attrs["real"] + prefill.attrs["padded"] == 16
    prefills = [r.attrs for r in recs if r.name == "serve.prefill"]
    assert eng.prefills == len(prefills)
    assert eng.prefill_positions == sum(a["real"] + a["padded"]
                                        for a in prefills)
    assert eng.prefill_padded == sum(a["padded"] for a in prefills)
    assert all(a["layers"] == CFG.layers and a["width"] == 16
               for a in prefills)
    waits = [r.attrs["on"] for r in recs if r.name == "serve.wait"]
    if drain:
        assert "item" in waits and "serve.reader_wait" not in names(recs)
    for name in ("serve.dispatch", "serve.post", "serve.drain"):
        assert all(by_id[r.parent].name == "serve.step" for r in recs
                   if r.name == name)


def test_batched_admission_spans():
    """A batched admission's span lists its requests, and its prefill
    counts every row's positions."""
    eng = tiny_engine(max_batch=8)
    with trace.enable():
        hs = [eng.submit([5 + i, 6], max_new_tokens=2) for i in range(8)]
        eng.step()
    many = next(r for r in trace.records() if r.name == "serve.admit_many")
    prefill = next(r for r in trace.records() if r.name == "serve.prefill")
    assert many.attrs["requests"] == [h.id for h in hs]
    assert prefill.parent == many.id
    assert prefill.attrs["requests"] == [h.id for h in hs]
    assert (prefill.attrs["real"], prefill.attrs["padded"]) == (16, 112)
    assert (eng.prefills, eng.prefill_positions, eng.prefill_padded) == \
        (1, 128, 112)


def test_training_loop_spans():
    """A ``Trainer.run`` of two steps: each ``train.step`` holds its
    ``train.data``, ``train.forward``, ``train.backward`` and
    ``train.optimizer`` (``train.clip`` and ``train.update`` inside), the
    first its ``train.log``; the last turn finds the stream ended."""
    from kosmosx_torch.train.trainer import TrainConfig, Trainer, lm_loss_fn

    cfg = TrainConfig(batch_size=2, seq_len=8, prefetch=False,
                      checkpoint_every=0, log_every=100, warmup_steps=0)
    trainer = Trainer(lambda g: KosmosLanguage(CFG, generator=g,
                                               device="cpu"),
                      lm_loss_fn(CFG), cfg, device="cpu")
    batches = [{"input_ids": torch.randint(4, 97, (2, 8))} for _ in range(2)]
    with trace.enable():
        trainer.run(iter(batches), log_fn=lambda step, m: None)
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    steps = [r for r in recs if r.name == "train.step"]
    assert [s.attrs.get("step") for s in steps] == [1, 2, None]

    def children(s):
        return [r.name for r in recs if r.parent == s.id]

    assert children(steps[0]) == ["train.data", "train.forward",
                                  "train.backward", "train.optimizer",
                                  "train.log"]
    assert children(steps[1]) == children(steps[0])[:4]
    assert children(steps[2]) == ["train.data"]
    for r in recs:
        if r.name in ("train.clip", "train.update"):
            assert by_id[r.parent].name == "train.optimizer"


def test_model_and_op_spans():
    """``Kosmos.apply`` of a W8 model: ``model.vision``, ``model.decoder``
    and ``model.head`` in turn, at the top; each op's span carries the
    shapes the benchmark's wrappers record (``perfbench/trace.py``)."""
    from perfbench import port, weights

    cfg = dict(perfbench_tiny.CONFIG, weights="w8")
    model = port.build_model(port.kosmos_config(cfg), weights.make_weights(
        cfg, 3, torch.device("cpu"), torch.bfloat16))
    toks = torch.randint(4, 64, (2, 12))
    imgs = torch.randn(2, 3, 28, 28)
    with trace.enable(), torch.inference_mode():
        model.apply(toks, imgs)
    top = [(r.name, r.parent) for r in trace.records()
           if r.name.startswith("model.")]
    assert top == [("model.vision", 0), ("model.decoder", 0),
                   ("model.head", 0)]

    q = torch.randn(2, 2, 8, 64)
    k = torch.randn(2, 2, 8, 64)
    codes = torch.randint(-127, 128, (128, 128), dtype=torch.int8)
    stack = torch.randint(-127, 128, (2, 128, 128), dtype=torch.int8)
    x = torch.randn(3, 5, 128)
    kv_len = torch.tensor([3, 8])
    with trace.enable():
        o, l_, m_ = tfa.flash_attention_fwd(q, k, k, causal=True)
        tfa.flash_attention_bwd(q, k, k, o, l_, m_, torch.randn_like(o))
        tdec.decode_attention(q[:, :, :1], k, k, kv_len)
        tqm.w8_matmul(x, codes, torch.rand(128))
        tqm.w8_matmul_stacked(x, stack, torch.rand(2, 1, 128), 1)
    ops = {r.name: r.attrs for r in trace.records()}
    fa = ops["op.flash_fwd"]
    assert (fa["b"], fa["h"], fa["lq"], fa["d"], fa["lk"], fa["causal"],
            fa["itemsize"]) == ptrace._qkv_shapes(q, k, causal=True)
    assert ops["op.flash_bwd"] == fa
    d = ops["op.decode_attention"]
    assert (d["h"], d["d"], d["q_itemsize"], d["kv_itemsize"],
            d["scales"]) == ptrace._decode_shapes(q[:, :, :1], k, k, kv_len)
    for name, q_ in (("op.w8_matmul", codes), ("op.w8_matmul_stacked",
                                                stack)):
        a = ops[name]
        assert (a["m"], a["k"], a["n"], a["itemsize"]) == \
            ptrace._w8_shapes(x, q_, None)


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_cli_trace_out(cli, tmp_path, capsys):
    """``--trace-out PATH`` holds tracing on for the run and writes its
    spans there as Chrome JSON: the engine's requests, the trainer's
    steps."""
    from kosmosx_torch.scripts import serve, train

    path = tmp_path / "t.json"
    tiny = ["--device", "cpu", "--layers", "2", "--dim", "64", "--ffn-dim",
            "128", "--heads", "2", "--max-positions", "256", "--trace-out",
            str(path)]
    if cli == "serve":
        assert serve.main(tiny + ["--dtype", "float32", "--no-flash",
                                  "--slots", "2", "--max-new-tokens", "3",
                                  "--prompt", "a b", "--prompt", "c"]) == 0
    else:
        assert train.main(tiny + ["--synthetic", "--seq-len", "16",
                                  "--steps", "2", "--no-final-save",
                                  "--output-dir", str(tmp_path / "run")]) == 0
    capsys.readouterr()
    assert trace.span("x") is trace.OFF
    events = json.loads(path.read_text())["traceEvents"]
    got = {e["name"] for e in events}
    if cli == "serve":
        assert {"serve.step", "serve.prefill", "serve.commit"} <= got
        assert {e["args"]["request"] for e in events
                if e["name"] == "serve.submit"} == {0, 1}
    else:
        assert {"train.step", "train.forward", "train.optimizer"} <= got


# -- the readers ---------------------------------------------------------------


_IDS = itertools.count(10 ** 9)


T0 = time.time_ns() // 1000   # µs, whole: the readers filter by the window


def put(name, start, end, parent=0, **attrs):
    """A finished span of the main thread from ``start`` to ``end`` µs
    after ``T0``."""
    s = trace.Span(name, attrs)
    s.id = next(_IDS)
    s.parent, s.thread = parent, threading.main_thread().native_id
    s.start, s.end = (T0 + start) * 1000, (T0 + end) * 1000
    trace._keep(s)
    return s


def serve_readings():
    """Kernels at 0-10, 30-40 and 60-100 µs (idle 10-30 and 40-60); an
    engine step whose admission (5-35, a prefill at 6-20 inside) and
    dispatch (50-70) overlap the idle time, a wait at 75-80 and a commit
    of the prefilled request's first token ending at 90."""
    put("serve.submit", 2, 2, request=5)   # an instant: holds no time
    step = put("serve.step", 0, 100)
    admit = put("serve.admit", 5, 35, step.id, request=4)
    put("serve.prefill", 6, 20, admit.id, request=4, real=30,
        padded=10, width=40, layers=2)
    put("serve.dispatch", 50, 70, step.id)
    put("serve.wait", 75, 80, step.id, on="reader")
    put("serve.commit", 85, 90, step.id, requests=[3, 4], tokens=[2, 1])
    kernels = [(T0 + a, T0 + b, "k", frozenset())
               for a, b in ((0, 10), (30, 40), (60, 100))]
    prof = ptrace.Profile(kernels, {}, [], 1.0)
    return Readings(1.0, 1, 0.0, prof, profile_steps=1)


def train_readings():
    """Kernels at 0-10 and 50-100 µs (idle 10-50); a step whose data
    (0-12) and optimizer (30-45) are idle-exposed, the forward 12-20 and
    nothing open at 45-50; and a forward's head of 2.5 device ms."""
    step = put("train.step", 0, 45)
    put("train.data", 0, 12, step.id)
    put("train.forward", 12, 20, step.id)
    opt = put("train.optimizer", 30, 45, step.id)
    put("train.clip", 31, 33, opt.id)
    head = put("model.head", 60, 70)
    head.device_ms = 2.5
    kernels = [(T0 + a, T0 + b, "k", frozenset())
               for a, b in ((0, 10), (50, 100))]
    prof = ptrace.Profile(kernels, {}, [], 1.0)
    return Readings(1.0, 1, 0.0, prof, profile_steps=1)


def optimizer_readings():
    """Two steps' ``train.update`` spans, each over 1 GB of parameters, 1 GB
    of moments and 0.5 GB of gradients, and 6 ms of kernels launched inside
    ``Optimizer.step``: 9 GB at 3.35 TB/s in 6 ms."""
    for start in (20, 60):
        put("train.update", start, start + 10, param_bytes=10**9,
            moment_bytes=10**9, grad_bytes=5 * 10**8, leaves=3)
    kernels = [(T0 + a, T0 + b, "k", frozenset())
               for a, b in ((0, 10), (50, 100))]
    prof = ptrace.Profile(kernels, {ptrace.OPTIMIZER: 6e-3}, [], 1.0)
    return Readings(1.0, 2, 0.0, prof, profile_steps=2)


def cut_readings():
    """Three engine steps; request 1, prefilled in the first, commits in
    the second (a lag of one step), so ``ttft_lag_ms`` leaves out the
    requests prefilled in the last step: request 2, whose commit the
    window cut, and request 3, whose short lag fit in, alike."""
    s0, s1, s2 = (put("serve.step", a, a + 100) for a in (0, 100, 200))
    put("serve.prefill", 10, 20, s0.id, request=1)
    put("serve.commit", 150, 160, s1.id, requests=[1], tokens=[1])
    put("serve.prefill", 210, 220, s2.id, request=2)
    put("serve.prefill", 230, 240, s2.id, request=3)
    put("serve.commit", 280, 290, s2.id, requests=[3], tokens=[1])
    kernels = [(T0 + a, T0 + a + 50, "k", frozenset()) for a in (0, 100, 200)]
    prof = ptrace.Profile(kernels, {}, [], 1.0)
    return Readings(1.0, 1, 0.0, prof, profile_steps=3)


READER_CASES = {
    "idle_admit_ms": (serve_readings, 0.020),
    "idle_dispatch_ms": (serve_readings, 0.010),
    "host_wait_ms": (serve_readings, 0.005),
    "prefill_pad_share": (serve_readings, 25.0),
    "ttft_lag_ms": (serve_readings, 0.070),
    "idle_optimizer_ms": (train_readings, 0.015),
    "idle_loop_ms": (train_readings, 0.017),
    "head_ms": (train_readings, 2.5),
    "ttft_lag_ms.window_end": (cut_readings, 0.140),
    "optimizer_roofline": (optimizer_readings, 100 * 9e9 / 3.35e12 / 6e-3),
}


@pytest.mark.parametrize("family", sorted(READER_CASES))
def test_reader_on_a_hand_built_profile(family):
    """Each reader's number on a profile where every interval is known
    (a case after a dot: another profile for the same reader); none reads
    a program without spans (the parent's) or no profile."""
    build, want = READER_CASES[family]
    reader = harness.load_module(pathlib.Path(perfbench_tiny.ROOT),
                                 "layer_metrics", family.split(".")[0])
    r = build()
    assert reader.read(r) == pytest.approx(want, rel=1e-6, abs=1e-9)
    assert reader.read(None) is None
    trace.clear()
    assert reader.read(r) is None


@pytest.mark.parametrize("build", [serve_readings, train_readings])
def test_idle_split_sums_to_the_idle_time(build):
    """The idle pieces, outside every span included, sum to the
    sub-window's idle time (within 1%, here exactly), and a piece's names
    run innermost first."""
    r = build()
    found = _spans.spans(r)
    pieces = _spans.idle_pieces(r, found)
    lo, hi = _spans.window(r.profile)
    idle = (hi - lo) - r.profile.busy_s() * 1e6
    assert sum(p for p, _ in pieces) == pytest.approx(idle, rel=0.01)
    if build is serve_readings:
        assert (10.0, ("serve.prefill", "serve.admit", "serve.step")) in [
            (round(p, 3), n) for p, n in pieces]
    else:
        assert (5.0, ()) in [(round(p, 3), n) for p, n in pieces]


@pytest.mark.parametrize("kind", ["serve", "score", "train"])
def test_readers_on_the_tiny_mixes(kind):
    """A traced tiny CPU run of each driver: every new reader runs, and
    those that need no kernel (a CPU run has none) read a number.

    The serve mix profiles 24 engine steps, as the benchmark's serving cell
    does, where the tiny mix has 2. The serve readers need a request
    prefilled and given its first token within the profiled steps, and the
    reader thread commits a first token up to ``overrun_window`` (3) steps
    after its prefill, later the busier the host. A slot frees at most
    6 + 3 + 1 steps after its admission (the mix's longest budget, the
    drain, the resend), so 24 steps always hold such a request."""
    c = perfbench_tiny.cell(kind)
    if kind == "serve":
        c.traffic["profile_steps"] = 24
    line = harness.run_cell(c, harness.Context(
        c, 2 ** 31 + 7, 0.5, True, torch.device("cpu"), time.perf_counter()))
    assert line["correct"]
    want = {"serve": {"prefill_pad_share.serve", "host_wait_ms.serve",
                      "ttft_lag_ms.serve"}}.get(kind, set())
    assert want <= set(line["metrics"])
    for name in want:
        assert line["metrics"][name]["value"] >= 0


@pytest.mark.cuda
def test_device_spans_on_the_card():
    """On the card a ``device=True`` span times the stream between its ends,
    and under the CUDA profiler no kernel launched inside it starts more
    than 10 µs before the span's host start (the clocks are shared)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events time the card")
    a = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    with trace.enable():
        with trace.span("mm", device=True):
            for _ in range(8):
                a = a @ a / 2048
    (rec,) = trace.records()
    assert rec.device_ms > 0
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            with trace.span("mm", device=True):
                b = a @ a
        torch.cuda.synchronize()
    del b
    spans = [r for r in trace.records() if r.name == "mm"]
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    kernel_start = {e.correlation_id(): e.start_ns() for e in events
                    if e.device_type() == cuda}
    launches = [(e.start_ns(), e.correlation_id()) for e in events
                if e.device_type() != cuda and e.name().startswith("cu")]
    checked = 0
    for s in spans:
        for t, corr in launches:
            if s.start <= t <= s.end and corr in kernel_start:
                assert kernel_start[corr] >= s.start - 10_000
                checked += 1
    assert len(spans) == 4 and checked >= 4
