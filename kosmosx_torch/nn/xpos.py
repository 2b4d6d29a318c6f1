"""xPos rotary position encoding with decay (kosmosx_tpu/nn/xpos.py).

Rotary angles at absolute positions ``offset + arange(L)`` over half the head
dim in rotate-every-two layout, and a per-dim decay
``zeta**((pos - center)/scale_base)`` that up-scales queries and down-scales
keys. ``offset`` is an int or a ``(B,)`` tensor (ragged decode positions);
``center`` is always given by the caller: ``L // 2`` for a full-sequence
forward, 0 under a KV cache (kosmosx_tpu/nn/attention.py:327,346), or a
``(B,)`` center that rolling-window generation slides forward
(``recenter_scale``).
"""

from __future__ import annotations

import math

import torch


def _zeta(head_dim: int, device=None) -> torch.Tensor:
    return ((torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
             + 0.4 * head_dim) / (1.4 * head_dim))


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """[x0, x1, x2, x3, ...] -> [-x1, x0, -x3, x2, ...] on the last axis."""
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack((-x2, x1), dim=-1).reshape(x.shape)


def xpos_sin_cos_scale(length: int, head_dim: int, *, offset=0,
                       scale_base: int = 512, center=0, device=None):
    """(sin, cos, scale), each ``(..., length, head_dim // 2)`` fp32, the
    leading dims from a ``(B,)`` offset (kosmosx_tpu/nn/xpos.py:42-63)."""
    half = head_dim // 2
    if isinstance(offset, torch.Tensor):
        device = offset.device
    offset = torch.as_tensor(offset, dtype=torch.float32, device=device)
    pos = offset[..., None] + torch.arange(length, dtype=torch.float32,
                                           device=device)
    center = torch.as_tensor(center, dtype=torch.float32, device=device)
    if center.ndim:
        center = center[..., None]
    power = (pos - center) / float(scale_base)
    scale = _zeta(head_dim, device) ** power[..., None]
    inv_freq = 1.0 / (10000.0 ** (torch.arange(
        0, half, dtype=torch.float32, device=device) / half))
    sinusoid = pos[..., None] * inv_freq
    return torch.sin(sinusoid), torch.cos(sinusoid), scale


def xpos_position_bound(scale_base: int = 512) -> int:
    """Largest distance from the decay center at which the key downscale
    ``zeta**(-pos/scale_base)`` still fits the fp32/bf16 exponent range
    (kosmosx_tpu/nn/xpos.py:66-78): the smallest zeta is 2/7 at any head
    dim, so ``scale_base * 127 / log2(7/2)``, about 36k at scale base
    512."""
    zeta0 = 0.4 / 1.4
    return int(scale_base * 127.0 / math.log2(1.0 / zeta0))


def recenter_scale(head_dim: int, delta, scale_base: int = 512,
                   device=None) -> torch.Tensor:
    """Per-dim fp32 factor ``zeta**(delta/scale_base)`` that moves a cached
    key's decay center forward by ``delta`` positions
    (kosmosx_tpu/nn/xpos.py:81-98); queries then rotate with
    ``center + delta``. ``delta`` is a
    scalar, giving ``(head_dim,)``, or ``(B,)``, giving ``(B, 1, 1,
    head_dim)`` against a (B, H, L, head_dim) cache."""
    if isinstance(delta, torch.Tensor):
        device = delta.device
    delta = torch.as_tensor(delta, dtype=torch.float32, device=device)
    factor = (_zeta(head_dim, device) ** (delta[..., None] / float(scale_base))
              ).repeat_interleave(2, dim=-1)
    if delta.ndim == 1:
        factor = factor[:, None, None, :]
    return factor


def xpos_tables(length: int, head_dim: int, *, offset=0, scale_base: int = 512,
                center=0, downscale: bool = False, device=None):
    """(sin, cos) with the decay folded in and each column repeated twice,
    ``(..., length, head_dim)`` fp32: ``apply_xpos(x) = x*cos +
    rotate_every_two(x)*sin``. The flash kernel's fused xPos reads these
    (kosmosx_tpu/ops/flash_attention.py:122-139)."""
    sin, cos, scale = xpos_sin_cos_scale(length, head_dim, offset=offset,
                                         scale_base=scale_base, center=center,
                                         device=device)
    if downscale:
        scale = 1.0 / scale
    return ((sin * scale).repeat_interleave(2, dim=-1),
            (cos * scale).repeat_interleave(2, dim=-1))


def apply_xpos(x: torch.Tensor, *, offset=0, scale_base: int = 512,
               downscale: bool = False, center=0) -> torch.Tensor:
    """Rotate and scale ``x`` (..., L, head_dim) in fp32 and cast back
    (kosmosx_tpu/nn/xpos.py:101-126). A ``(B,)`` offset needs ``x`` of shape
    (B, ..., L, head_dim)."""
    length, head_dim = x.shape[-2], x.shape[-1]
    sin, cos = xpos_tables(length, head_dim, offset=offset,
                           scale_base=scale_base, center=center,
                           downscale=downscale, device=x.device)
    if sin.ndim == 3:  # per-row tables (B, L, hd) against (B, ..., L, hd)
        shape = (sin.shape[0],) + (1,) * (x.ndim - 3) + sin.shape[1:]
        sin, cos = sin.reshape(shape), cos.reshape(shape)
    x32 = x.float()
    return (x32 * cos + rotate_every_two(x32) * sin).to(x.dtype)
