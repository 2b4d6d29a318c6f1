"""Parameter initializers on an explicit ``torch.Generator``
(counterpart of kosmosx_tpu/core/initializers.py).

The schemes are the JAX package's: xavier-uniform projections, the Magneto
gain ``sqrt(log(2N))`` on fc1/fc2/out/v, and N(0, d**-0.5) for the output and
image projections and the embedding tables. The random numbers differ from
``jax.random``'s for the same seed; tests that compare the two packages carry
the JAX weights across with ``kosmosx_torch.utils.jax_params``.

All initializers return fp32 tensors on ``device``.
"""

from __future__ import annotations

import math

import torch


def magneto_gamma(num_layers: int) -> float:
    """Magneto decoder-only init gain: sqrt(log(2N))
    (kosmosx_tpu/core/initializers.py:22)."""
    return math.sqrt(math.log(2.0 * num_layers))


def xavier_uniform(gen: torch.Generator, shape, gain: float = 1.0,
                   device=None) -> torch.Tensor:
    """Glorot uniform for an ``(in, out)`` weight, applied as ``x @ w``
    (kosmosx_tpu/core/initializers.py:27)."""
    fan_in, fan_out = shape[0], shape[-1]
    limit = gain * math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u.mul_(2.0 * limit).sub_(limit)


def normal(gen: torch.Generator, shape, std: float = 1.0,
           device=None) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).mul_(std)


def zeros(shape, device=None) -> torch.Tensor:
    return torch.zeros(shape, device=device, dtype=torch.float32)


def ones(shape, device=None) -> torch.Tensor:
    return torch.ones(shape, device=device, dtype=torch.float32)


def magneto_output_projection(gen: torch.Generator, shape,
                              device=None) -> torch.Tensor:
    """N(0, d_model**-0.5) (kosmosx_tpu/core/initializers.py:50)."""
    return normal(gen, shape, std=shape[0] ** -0.5, device=device)


def embedding_init(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """N(0, d**-0.5) tables (kosmosx_tpu/core/initializers.py:57)."""
    return normal(gen, shape, std=shape[-1] ** -0.5, device=device)
