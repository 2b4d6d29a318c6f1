"""The traced run's instruments: spans around the program's entry points,
a profiled sub-window, and its reduction to device times.

Spans are ``torch.profiler.record_function`` ranges that the benchmark
wraps around the port's public entry points (``flash_attention_fwd``,
``flash_attention_bwd``, ``decode_attention``, ``w8_matmul``,
``w8_matmul_stacked``, ``Optimizer.step``) and around the window's own
calls, for the profiled sub-window only. They change nothing inside the
program: each wrapper records its call's shapes, opens the range and calls
the original. The program's launch counters live on the function objects,
and a wrapper carries them on, so every call the wrappers saw can be
checked against the launches counted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

# kernel-name groups, first match wins (the program's chip_profile.py)
GROUPS = (
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
ELEMENTWISE_GROUPS = ("elementwise_copy", "reduce")


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


@dataclasses.dataclass
class Call:
    """One call of a wrapped entry point: its span label and arguments'
    shapes (and, for the decode kernel, its ``kv_len`` on the device)."""

    label: str
    shapes: Tuple
    extra: Optional[torch.Tensor] = None


class Spans:
    """Installs the wrappers, keeps the calls they saw, and removes them."""

    def __init__(self):
        self.calls: List[Call] = []
        self._undo: List[Callable[[], None]] = []
        self.counters: Dict[str, Callable[[], int]] = {}

    def _patch(self, owner, attr: str, wrapper):
        original = getattr(owner, attr)
        for name in ("launches", "hopper_launches"):
            if hasattr(original, name):
                setattr(wrapper, name, getattr(original, name))
        setattr(owner, attr, wrapper)

        def undo():
            for name in ("launches", "hopper_launches"):
                if hasattr(wrapper, name):
                    setattr(original, name, getattr(wrapper, name))
            setattr(owner, attr, original)

        self._undo.append(undo)
        return original

    def wrap(self, owner, attr: str, label: str,
             shapes: Callable[..., Tuple], extra=None):
        original = getattr(owner, attr)

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            self.calls.append(Call(label, shapes(*args, **kwargs),
                                   None if extra is None
                                   else extra(*args, **kwargs)))
            with torch.profiler.record_function(label):
                return original(*args, **kwargs)

        self._patch(owner, attr, wrapper)

    def phase(self, owner, attr: str, label: str):
        """A span around a method or function, recording no call."""
        original = getattr(owner, attr)

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(label):
                return original(*args, **kwargs)

        self._patch(owner, attr, wrapper)

    def remove(self):
        while self._undo:
            self._undo.pop()()

    def count(self, label: str) -> int:
        return sum(c.label == label for c in self.calls)


def _qkv_shapes(q, k, *args, causal=True, **kwargs):
    """(b, h, lq, d, lk, causal, itemsize) of a flash entry's call."""
    return tuple(q.shape) + (k.shape[2], bool(causal), q.element_size())


def _w8_shapes(x, q, scale, *args, **kwargs):
    m = x.numel() // x.shape[-1]
    return (m, x.shape[-1], q.shape[-1], x.element_size())


def _decode_shapes(q, k, v, kv_len, *, k_scale=None, v_scale=None):
    return (q.shape[1], q.shape[3], q.element_size(), k.element_size(),
            k_scale is not None)


# the entry points and the launch counters that must count their calls
FLASH_FWD, FLASH_BWD = "flash_attention_fwd", "flash_attention_bwd"
DECODE, W8, W8_STACKED = "decode_attention", "w8_matmul", "w8_matmul_stacked"
OPTIMIZER = "Optimizer.step"


def install(spans: Spans) -> None:
    """Wrap every entry point in the port's modules where its callers look
    it up."""
    from kosmosx_torch.nn import attention
    from kosmosx_torch.ops import decode_attention as da
    from kosmosx_torch.ops import flash_attention as fa
    from kosmosx_torch.ops import quant_matmul as qm
    from kosmosx_torch.train import optim

    spans.wrap(fa, FLASH_FWD, FLASH_FWD, _qkv_shapes)
    spans.wrap(fa, FLASH_BWD, FLASH_BWD, _qkv_shapes)
    spans.wrap(attention, DECODE, DECODE, _decode_shapes,
               extra=lambda q, k, v, kv_len, **kw: kv_len.detach().clone())
    spans.wrap(qm, W8, W8, _w8_shapes)
    spans.wrap(qm, W8_STACKED, W8_STACKED, _w8_shapes)
    spans.phase(optim.Optimizer, "step", OPTIMIZER)
    spans.counters = {
        FLASH_FWD: lambda: fa.flash_attention.launches,
        FLASH_BWD: lambda: fa.flash_bwd_dkv.launches,
        DECODE: lambda: da.decode_attention.launches,
        # the W8 wrappers carry the counters while they are installed
        W8: lambda: qm.w8_matmul.launches,
        W8_STACKED: lambda: qm.w8_matmul_stacked.launches,
    }


def launch_counts(spans: Spans) -> Dict[str, int]:
    """The program's launch counters of each wrapped entry point, now."""
    return {label: int(read()) for label, read in spans.counters.items()}


def check_spans(spans: Spans, before: Dict[str, int], device) -> None:
    """Every launch the program counted since ``before`` went through a
    span: else the wrapping missed a caller, and a roofline would read
    wrong. (The program counts launches on the card only.)"""
    if torch.device(device).type != "cuda":
        return
    after = launch_counts(spans)
    for label in after:
        launched = after[label] - before[label]
        if launched != spans.count(label):
            raise RuntimeError(f"{label}: {launched} launches counted, "
                               f"{spans.count(label)} calls in spans")


# ---------------------------------------------------------------------------
# the profile and its reduction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Profile:
    """What a profiled sub-window gives: kernel intervals (µs) with their
    names and the span labels open at their launch, device seconds inside
    each span label, the labelled host spans, the window's length (s)."""

    kernels: List[Tuple[float, float, str, frozenset]]
    span_device_s: Dict[str, float]
    host_spans: List[Tuple[float, float, str]]
    window_s: float

    def busy_s(self) -> float:
        """The union of the kernel intervals, in seconds."""
        total, end = 0.0, None
        for s, e, *_ in sorted(self.kernels):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def group_s(self, groups, outside: str = None) -> float:
        """Seconds of the kernels of ``groups``, those launched inside a
        span ``outside`` left out."""
        return sum(e - s for s, e, n, spans in self.kernels
                   if group_of(n) in groups and outside not in spans) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, name, _ in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps between busy intervals, each named by the
        innermost span the host was in when it began."""
        gaps, end = [], None
        for s, e, *_ in sorted(self.kernels):
            if end is not None and s > end:
                gaps.append((s - end, end))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for length, start in gaps[:n]:
            inside = [(hs, he, lab) for hs, he, lab in self.host_spans
                      if hs <= start <= he]
            label = min(inside, key=lambda x: x[1] - x[0])[2] if inside \
                else "host"
            out.append([label, length / 1e6])
        return out


@contextlib.contextmanager
def profiled(labels, device):
    """Profile CPU and CUDA activity; yields a dict that holds the
    ``Profile`` once the block has closed."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.window import sync

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    box: Dict[str, Profile] = {}
    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield box
        sync(device)
        window = time.perf_counter() - t0
    box["profile"] = reduce(prof, labels, window)


def reduce(prof, labels, window_s: float) -> Profile:
    """Kernel intervals, the device time of the kernels launched inside
    each labelled span (nested spans included), the labelled host spans.

    A kernel belongs to the spans open on its launching thread when the
    runtime call that launched it began (matched by correlation id): that
    holds for the kernels the port launches through its own library as for
    PyTorch's."""
    labels = set(labels)
    cuda = torch.autograd.DeviceType.CUDA
    marks, launches, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == cuda:
            if e.name() not in labels:   # not the span's device-side copy
                device.append((start, end, e.name(), e.correlation_id()))
        elif e.name() in labels:
            marks.append((start, 0, e.start_thread_id(), e.name()))
            marks.append((end, 2, e.start_thread_id(), e.name()))
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = None
            marks.append((start, 1, e.start_thread_id(), e.correlation_id()))
    # sweep the host's timeline: the labels open at each launch
    open_spans: Dict[int, List[str]] = {}
    host_spans, opened = [], {}
    for t, kind, tid, what in sorted(marks, key=lambda m: (m[0], m[1])):
        stack = open_spans.setdefault(tid, [])
        if kind == 0:
            stack.append(what)
            opened[(tid, len(stack))] = t
        elif kind == 2:
            if what in stack:
                depth = len(stack) - stack[::-1].index(what)
                host_spans.append((opened.pop((tid, depth), t) / 1e3,
                                   t / 1e3, what))
                del stack[depth - 1]
        else:
            launches[what] = frozenset(stack)
    span_ns = dict.fromkeys(labels, 0)
    kernels = []
    for start, end, name, corr in device:
        spans = launches.get(corr) or frozenset()
        kernels.append((start / 1e3, end / 1e3, name, spans))
        for label in spans:
            span_ns[label] += end - start
    return Profile(kernels, {k: v / 1e9 for k, v in span_ns.items()},
                   host_spans, window_s)
