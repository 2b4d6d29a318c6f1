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
