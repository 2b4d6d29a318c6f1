"""``layer_norm_ms``: device milliseconds a step (a training step, a
forward) spends in the program's LayerNorm kernels, those whose names hold
``kx_layer_norm`` (``kosmosx_torch/csrc/layer_norm.cu``: forward, backward
and the backward's column sums), from the traced run's profiled steps.
None where no such kernel ran, as in a program without them."""

KERNEL = "kx_layer_norm"


def read(r):
    if r is None or r.profile is None or not r.profile_steps:
        return None
    us = sum(end - start for start, end, name, _ in r.profile.kernels
             if KERNEL in name)
    return us / 1e3 / r.profile_steps if us else None
