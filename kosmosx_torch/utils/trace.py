"""Spans inside the port, on the clock of ``torch.profiler``'s events.

``span(name, **attrs)`` is a context manager around a piece of host work:
its record holds the name, an id, the id of the span open on the same
thread when it opened (its parent, 0 at the top), the thread's native id,
start and end from ``time.time_ns()`` and the attributes. ``torch.profiler``
stamps its events in the same Unix nanoseconds, so a span lands on a
profiler trace's timeline with no calibration. Spans of one serving
request carry its ``Request.id`` under ``request`` (``requests``, a list,
where one program serves several).

Tracing is on while ``enable()`` holds or while a ``torch.profiler``
records; otherwise ``span`` returns one shared no-op object after reading
two module flags. While a profiler records, each span also opens a
profiler range of its name, so an exported profiler trace shows it. The
range is a ``FUNCTION``-scope record (``_RecordFunctionFast``), not a
``record_function``: the profiler draws a user annotation's range again on
the device's timeline, which a reader that takes device events for kernels
would count as busy time.

A span opened with ``device=True`` also records a pair of CUDA timing
events on the current stream (while tracing is on and CUDA is
initialised); its ``device_ms`` is resolved when the records are read or
written, never inside the traced work. Attributes that cost something to
build are set through ``set`` behind the span's ``on``::

    with trace.span("op.w8_matmul", device=True) as s:
        if s.on:
            s.set(m=m, k=k, n=n)

Records are kept in memory, the newest 131,072 of them by default (the
oldest dropped and counted: ``dropped()``); ``records()`` returns them,
``clear()`` empties the buffer and ``write_chrome(path)`` writes Chrome
trace-event JSON. The buffer and the flags are process-wide, as
``logging``'s are.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_Range = torch._C._profiler._RecordFunctionFast

_enabled = 0                 # the depth of enable() blocks
_ids = itertools.count(1)
_lock = threading.Lock()
_buffer: collections.deque = collections.deque(maxlen=1 << 17)
_dropped = 0
_local = threading.local()


class _Off:
    """The span of a call made while tracing is off: records nothing."""

    __slots__ = ()
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


def _thread():
    """This thread's open spans (``stack``) and native id (``tid``, read
    once: it is a system call)."""
    if not hasattr(_local, "stack"):
        _local.stack = []
        _local.tid = threading.get_native_id()
    return _local


def _keep(record: "Span") -> None:
    global _dropped
    with _lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(record)


class Span:
    """A span while it is open, and its record once it has closed."""

    __slots__ = ("name", "attrs", "id", "parent", "thread", "start", "end",
                 "device_ms", "_device", "_range", "_events")
    on = True

    def __init__(self, name: str, attrs: dict, device: bool = False):
        self.name, self.attrs, self._device = name, attrs, device
        self.id = self.parent = self.thread = self.start = self.end = 0
        self.device_ms: Optional[float] = None
        self._range = self._events = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        local = _thread()
        stack = local.stack
        self.parent = stack[-1].id if stack else 0
        self.id = next(_ids)
        self.thread = local.tid
        stack.append(self)
        self.start = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._range = _Range(self.name)
            self._range.__enter__()
        if self._device and torch.cuda.is_initialized():
            first = torch.cuda.Event(enable_timing=True)
            first.record()
            self._events = (first, None)
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            last = torch.cuda.Event(enable_timing=True)
            last.record()
            self._events = (self._events[0], last)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.end = time.time_ns()
        stack = _thread().stack
        if stack and stack[-1] is self:
            stack.pop()
        _keep(self)
        return False

    def _resolve(self) -> None:
        events = self._events
        if events is not None and events[1] is not None:
            events[1].synchronize()
            self.device_ms = events[0].elapsed_time(events[1])
            self._events = None

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{(self.end - self.start) / 1e3:.1f} us, {self.attrs})")


def span(name: str, device: bool = False, **attrs):
    """A span named ``name`` with ``attrs``; ``device=True`` also times the
    device's stream between its ends. The shared no-op ``OFF`` while
    tracing is off."""
    if not _enabled and not _autograd_profiler._is_profiler_enabled:
        return OFF
    return Span(name, attrs, device)


def instant(name: str, **attrs) -> None:
    """A span of no length, now (its parent the span open on this
    thread)."""
    if not _enabled and not _autograd_profiler._is_profiler_enabled:
        return
    s = Span(name, attrs)
    local = _thread()
    s.parent = local.stack[-1].id if local.stack else 0
    s.id = next(_ids)
    s.thread = local.tid
    s.start = s.end = time.time_ns()
    _keep(s)


@contextlib.contextmanager
def enable() -> Iterator[None]:
    """Tracing on while the block runs (blocks may nest)."""
    global _enabled
    _enabled += 1
    try:
        yield
    finally:
        _enabled -= 1


@contextlib.contextmanager
def to_chrome(path: Optional[str]) -> Iterator[None]:
    """Tracing on while the block runs, the records written to ``path``
    (``write_chrome``) when it ends, however it ends; with ``path`` None,
    nothing (the CLIs' ``--trace-out``)."""
    if path is None:
        yield
        return
    with enable():
        try:
            yield
        finally:
            write_chrome(path)


def records() -> List[Span]:
    """The finished spans kept, oldest first, their device times
    resolved (waiting for the card where a span's end has not run yet)."""
    with _lock:
        out = list(_buffer)
    for r in out:
        r._resolve()
    return out


def clear() -> None:
    """Empty the buffer and zero the drop count."""
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0


def dropped() -> int:
    """Records dropped, oldest first, since the last ``clear``."""
    return _dropped


def write_chrome(path: str) -> int:
    """Write the kept records to ``path`` as Chrome trace-event JSON (open
    it in Perfetto or chrome://tracing); returns the number of events.
    Timestamps are µs on the Unix clock, as the profiler stamps its events
    (a ``torch.profiler`` export writes its own as µs after its
    ``baseTimeNanoseconds``, a field this file leaves at 0)."""
    pid = os.getpid()
    events = []
    for r in records():
        args = {"id": r.id, "parent": r.parent, **r.attrs}
        if r.device_ms is not None:
            args["device_ms"] = r.device_ms
        e = {"name": r.name, "cat": "kosmosx", "pid": pid, "tid": r.thread,
             "ts": r.start / 1e3, "args": args}
        if r.end > r.start:
            e.update(ph="X", dur=(r.end - r.start) / 1e3)
        else:
            e.update(ph="i", s="t")
        events.append(e)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": 0,
                   "otherData": {"dropped": dropped()}}, f, default=str)
    return len(events)
