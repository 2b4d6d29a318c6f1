"""Timing a window by the host clock, and the helpers the drivers share."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, Optional

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Pacer:
    """Tells a loop that enqueues work on the card when its window is
    over, without idling the card: at each turn it marks the end of the
    work enqueued so far and waits only for the mark of the turn before,
    so one turn's work stays queued while the host looks at the clock."""

    def __init__(self, device, seconds: float):
        self.device = torch.device(device)
        self.seconds = seconds
        sync(self.device)
        self.t0 = time.perf_counter()
        self._prev = None

    def more(self) -> bool:
        if self.device.type == "cuda":
            mark = torch.cuda.Event()
            mark.record()
            if self._prev is not None:
                self._prev.synchronize()
            self._prev = mark
        return time.perf_counter() - self.t0 < self.seconds

    def close(self) -> float:
        """Wait for the card; the window's length in seconds."""
        sync(self.device)
        return time.perf_counter() - self.t0


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read in a traced run: the unprofiled
    window's length, its model FLOPs and steps; the profiled sub-window
    (``trace.Profile``), its steps and the calls its spans saw; the
    serving engine's own counters."""

    window_s: float
    steps: int
    model_flops: float
    profile: Any = None
    profile_steps: int = 0
    calls: list = dataclasses.field(default_factory=list)
    engine: Dict[str, Optional[float]] = dataclasses.field(
        default_factory=dict)
