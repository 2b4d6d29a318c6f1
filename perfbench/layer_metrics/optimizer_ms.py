"""``optimizer_ms``: device milliseconds a training step spends in the
kernels launched inside ``Optimizer.step`` (the clip and the update),
from the traced run's profiled steps."""

from perfbench import trace


def read(r):
    if r is None or r.profile is None or not r.profile_steps:
        return None
    s = r.profile.span_device_s.get(trace.OPTIMIZER)
    return 1e3 * s / r.profile_steps if s else None
