"""What the per-layer metrics that read the program's own spans share.

The port records spans (``kosmosx_torch/utils/trace.py``) while a
``torch.profiler`` records, so the traced run's profiled sub-window
collects them with no change to the drivers. Their times are Unix
nanoseconds (whole numbers: divided by an integer they convert to µs
exactly rounded), the clock of the profile's kernels (µs). A program
without those spans (one older than them) gives every reader None.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

ADMIT = ("serve.admit", "serve.admit_many")
LOOP_WORK = ("train.forward", "train.backward", "train.optimizer")


def window(profile) -> Optional[Tuple[float, float]]:
    """The profiled sub-window (µs): from its first kernel's start to its
    last kernel's end; with no kernel (a CPU run), the extent of the
    benchmark's own host spans."""
    if profile.kernels:
        return (min(k[0] for k in profile.kernels),
                max(k[1] for k in profile.kernels))
    if profile.host_spans:
        return (min(h[0] for h in profile.host_spans),
                max(h[1] for h in profile.host_spans))
    return None


def spans(r) -> Optional[list]:
    """The program's span records that overlap the sub-window, or None
    where there are none to read."""
    if r is None or r.profile is None or not r.profile_steps:
        return None
    try:
        from kosmosx_torch.utils import trace
    except ImportError:
        return None
    bounds = window(r.profile)
    if bounds is None:
        return None
    lo, hi = bounds
    out = [s for s in trace.records()
           if s.end / 1000 >= lo and s.start / 1000 <= hi]
    return out or None


def main_thread(found: list) -> list:
    native = threading.main_thread().native_id
    return [s for s in found if s.thread == native]


def segments(found: list) -> List[Tuple[float, float, tuple]]:
    """The main thread's timeline (µs) cut where a span opens or closes:
    (start, end, names of the spans open over it, innermost first)."""
    events = []
    for s in main_thread(found):
        if s.end == s.start:   # an instant holds no time
            continue
        events.append((s.start, 1, s.id, s))
        events.append((s.end, 0, -s.id, s))
    events.sort(key=lambda e: e[:3])   # ends first; parents open first
    out, stack, last = [], [], None
    for t, opening, _, s in events:
        if last is not None and t > last:
            out.append((last / 1000, t / 1000,
                        tuple(x.name for x in reversed(stack))))
        last = t
        if opening:
            stack.append(s)
        elif s in stack:
            stack.remove(s)
    return out


def idle_pieces(r, found: list) -> List[Tuple[float, tuple]]:
    """The sub-window's device-idle time (the complement of its kernels'
    union), each piece (µs, names of the main thread's spans open over
    it, innermost first; empty outside every span). The pieces sum to the
    idle time."""
    lo, hi = window(r.profile)
    idle, cur = [], lo
    for s, e, *_ in sorted(r.profile.kernels):
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        idle.append((cur, hi))
    pieces = []
    segs = segments(found)
    j = 0
    for a, b in idle:
        t = a
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while t < b:
            if k < len(segs) and segs[k][0] < b:
                s0, s1, names = segs[k]
                if s0 > t:
                    pieces.append((s0 - t, ()))
                    t = s0
                end = min(s1, b)
                if end > t:
                    pieces.append((end - t, names))
                    t = end
                k += 1
            else:
                pieces.append((b - t, ()))
                t = b
    return pieces


def idle_ms(r, under=(), outside_of=()) -> Optional[float]:
    """Device-idle ms a profiled step while the main thread is inside a
    span named in ``under`` (or, with ``outside_of``, inside none of
    those)."""
    found = spans(r)
    if found is None or not r.profile.kernels:
        return None
    us = 0.0
    for length, names in idle_pieces(r, found):
        if under and set(under) & set(names):
            us += length
        elif outside_of and not set(outside_of) & set(names):
            us += length
    return us / 1e3 / r.profile_steps
