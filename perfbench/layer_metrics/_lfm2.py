"""What the LFM2 cell's per-layer metrics that read the program's own
spans share: their device times and their arguments' bounds."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from perfbench import roofline
from perfbench.layer_metrics import _spans


def _found(r, names: Sequence[str]) -> Optional[list]:
    found = _spans.spans(r)
    if found is None:
        return None
    picked = [s for s in found if s.name in names]
    if not picked or any(s.device_ms is None for s in picked):
        return None
    return picked


def span_ms(r, names: Sequence[str]) -> Optional[float]:
    """Device ms a profiled step inside the spans named ``names``."""
    picked = _found(r, names)
    if picked is None:
        return None
    return sum(s.device_ms for s in picked) / r.profile_steps


def share(r, names: Sequence[str],
          work: Dict[str, Callable[[dict], roofline.Work]]
          ) -> Optional[float]:
    """The spans' share of their roofline, in percent: the least time of
    each span's work (``work[name](attrs)``) over their device time."""
    picked = _found(r, names)
    if picked is None:
        return None
    device_s = sum(s.device_ms for s in picked) / 1e3
    if device_s <= 0:
        return None
    bound = sum(roofline.bound_s(work[s.name](s.attrs)) for s in picked)
    return 100.0 * bound / device_s
