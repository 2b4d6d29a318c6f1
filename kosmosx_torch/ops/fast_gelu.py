"""Polynomial erf-gelu in plain torch (kosmosx_tpu/ops/fast_gelu.py).

In JAX this is jnp code, not a Pallas kernel, so it ports as tensor code.
The coefficients and the guard are the JAX module's; see its docstring for
the fit and its measured accuracy.
"""

from __future__ import annotations

import torch

_C = (
    0.7978828682178812,
    0.036343200198652635,
    -4.3983891272934235e-05,
    -5.0548261841443504e-05,
    3.1086679874847133e-06,
    -6.628358746501451e-08,
)
_QE = 0.1
_QF = -1.569069562707193


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """x · Φ(x) in fp32, cast back to the input dtype
    (kosmosx_tpu/ops/fast_gelu.py:67)."""
    xf = x.float()
    u = xf * xf
    p = torch.full_like(u, _C[-1])
    for c in _C[-2::-1]:
        p = p * u + c
    p = torch.maximum(p, _QE * u + _QF)
    half = 0.5 * xf
    return (half * torch.tanh(xf * p) + half).to(x.dtype)
