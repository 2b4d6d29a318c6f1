"""``rms_norm_ms``: device milliseconds a forward spends in the program's
RMSNorm kernels, those whose names hold ``kx_rms_norm``
(``kosmosx_torch/csrc/layer_norm.cu``), from the traced run's profiled
forwards. None where no such kernel ran, as in a program without them."""

KERNEL = "kx_rms_norm"


def read(r):
    if r is None or r.profile is None or not r.profile_steps:
        return None
    us = sum(end - start for start, end, name, _ in r.profile.kernels
             if KERNEL in name)
    return us / 1e3 / r.profile_steps if us else None
