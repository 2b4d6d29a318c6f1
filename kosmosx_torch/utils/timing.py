"""Device time of a call on the card, for ``chip_smoke.py`` and the
studies."""

from __future__ import annotations

import torch


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches, CUDA
    events around them, after a warm-up long enough for the card to leave
    its idle clocks."""
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
