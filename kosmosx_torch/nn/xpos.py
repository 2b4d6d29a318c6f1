"""xPos rotary position encoding with decay (kosmosx_tpu/nn/xpos.py).

Rotary angles at absolute positions ``offset + arange(L)`` over half the head
dim in rotate-every-two layout, and a per-dim decay
``zeta**((pos - center)/scale_base)`` that up-scales queries and down-scales
keys. ``offset`` is an int or a ``(B,)`` tensor (ragged decode positions);
``center`` is always given by the caller: ``L // 2`` for a full-sequence
forward, 0 under a KV cache (kosmosx_tpu/nn/attention.py:327,346).
"""

from __future__ import annotations

import torch


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
    zeta = ((torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
             + 0.4 * head_dim) / (1.4 * head_dim))
    scale = zeta ** power[..., None]
    inv_freq = 1.0 / (10000.0 ** (torch.arange(
        0, half, dtype=torch.float32, device=device) / half))
    sinusoid = pos[..., None] * inv_freq
    return torch.sin(sinusoid), torch.cos(sinusoid), scale


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
