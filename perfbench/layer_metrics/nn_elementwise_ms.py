"""``nn_elementwise_ms``: device milliseconds a step (a training step, a
forward) spends in elementwise, copy and reduction kernels outside
``Optimizer.step`` (the models' and layers' unfused tensor code; the
optimizer's own is ``optimizer_ms``), from the traced run's profiled
steps."""

from perfbench import trace


def read(r):
    if r is None or r.profile is None or not r.profile_steps:
        return None
    s = r.profile.group_s(trace.ELEMENTWISE_GROUPS, outside=trace.OPTIMIZER)
    return 1e3 * s / r.profile_steps if s else None
