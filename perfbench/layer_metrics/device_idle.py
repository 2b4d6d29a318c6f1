"""``device_idle``: the share of a step in which no operation runs on
the device: one minus the device's busy time a step (the union of the
kernels' intervals over the profiled steps, a step's worth) over the wall
time a step took in the unprofiled window. (The profiler slows the host,
so the profiled steps' own wall time would read the profiler.)"""


def read(r):
    if r is None or r.profile is None or not r.profile.kernels \
            or not r.profile_steps or not r.steps or r.window_s <= 0:
        return None
    busy = r.profile.busy_s() / r.profile_steps
    return 100.0 * (1.0 - busy / (r.window_s / r.steps))
