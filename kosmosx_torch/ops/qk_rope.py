"""QK-norm and RoPE before the flash forward: the CUDA kernel
``kx_qk_norm_rope`` of ``csrc/lfm2.cu`` and its plain PyTorch version.

The JAX package has no LFM2 model, so this replaces no Pallas kernel. The
LFM2 attention projects x to q (H heads), k and v (Hkv heads each) of 64,
normalises q and k per head (RMSNorm over the head's 64 values times the
head's weight), rotates them (RoPE in rotate-half form, positions 0..L-1 of
each row, ``inv_freq = theta ** (-2 i / 64)``), and hands q, k and v in the
flash kernels' (B, heads, L, 64) layout to the flash forward. In plain
torch that is a dozen launches over q and k, two transposing copies and
one for v. The kernel reads the projection's (B L, (H + 2 Hkv) 64) rows
once and writes the three tensors once, in fp32 math with one rounding to
the input dtype.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from kosmosx_torch.utils import trace

HEAD_DIM = 64


@functools.lru_cache(maxsize=8)
def rope_tables(length: int, theta: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (length, 32) fp32: the angles ``p * inv_freq[i]``
    of positions 0..length-1, ``inv_freq = 1 / theta ** (2 i / 64)``, as
    the published rotary embedding computes them in fp32. Cached: every
    attention layer of a forward asks for the same tables. Callers only
    read them."""
    exps = torch.arange(0, HEAD_DIM, 2, dtype=torch.int64,
                        device=device).float() / HEAD_DIM
    inv_freq = 1.0 / (theta ** exps)
    pos = torch.arange(length, device=device, dtype=torch.float32)
    ang = pos[:, None] * inv_freq[None, :]
    return ang.cos(), ang.sin()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """RoPE in rotate-half form on fp32 (..., L, 64) from (L, 32) tables."""
    c = torch.cat([cos, cos], dim=-1)
    s = torch.cat([sin, sin], dim=-1)
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rot * s


def qk_norm_rope_plain(qkv: torch.Tensor, q_scale: torch.Tensor,
                       k_scale: torch.Tensor, *, batch: int, heads: int,
                       kv_heads: int, theta: float, eps: float = 1e-5):
    """The kernel's function in plain torch, fp32 math: (q (B, H, L, 64),
    k (B, Hkv, L, 64), v (B, Hkv, L, 64)) in qkv's dtype."""
    t = qkv.shape[0]
    length = t // batch
    x = qkv.float().view(batch, length, heads + 2 * kv_heads, HEAD_DIM)
    x = x.transpose(1, 2)                               # (B, NH, L, 64)
    q, k, v = x.split([heads, kv_heads, kv_heads], dim=1)
    cos, sin = rope_tables(length, float(theta), qkv.device)

    def norm(y, w):
        r = torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + eps)
        return y * r * w.float()

    q = _rope(norm(q, q_scale), cos, sin)
    k = _rope(norm(k, k_scale), cos, sin)
    return tuple(z.to(qkv.dtype).contiguous() for z in (q, k, v))


def _check(qkv, q_scale, k_scale, batch, heads, kv_heads) -> None:
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qk_norm_rope takes float32 or bfloat16, got "
                        f"{qkv.dtype}")
    nh = heads + 2 * kv_heads
    if qkv.dim() != 2 or qkv.shape[1] != nh * HEAD_DIM \
            or qkv.shape[0] % batch:
        raise ValueError(f"qkv must be (B L, {nh} * {HEAD_DIM}) for batch "
                         f"{batch}; got {tuple(qkv.shape)}")
    for name, w in (("q_scale", q_scale), ("k_scale", k_scale)):
        if tuple(w.shape) != (HEAD_DIM,):
            raise ValueError(f"{name} must be ({HEAD_DIM},); got "
                             f"{tuple(w.shape)}")


def qk_norm_rope(qkv: torch.Tensor, q_scale: torch.Tensor,
                 k_scale: torch.Tensor, *, batch: int, heads: int,
                 kv_heads: int, theta: float, eps: float = 1e-5):
    """q, k and v for the flash forward from the attention's projection
    rows: the kernel inside an ``op.qk_norm_rope`` span on a CUDA tensor,
    ``qk_norm_rope_plain`` on a CPU one. The kernel takes bfloat16, the
    plain version float32 too."""
    _check(qkv, q_scale, k_scale, batch, heads, kv_heads)
    kw = dict(batch=batch, heads=heads, kv_heads=kv_heads, theta=theta,
              eps=eps)
    if qkv.device.type == "cpu":
        return qk_norm_rope_plain(qkv, q_scale, k_scale, **kw)
    if qkv.device.type != "cuda":
        raise ValueError(f"qk_norm_rope runs on cpu or cuda, not "
                         f"{qkv.device}")
    from kosmosx_torch.ops import _build

    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the qk_norm_rope kernel takes bfloat16 (the plain "
                        f"version runs float32 on the CPU); got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the qk_norm_rope kernel takes a contiguous, "
                         "16-byte aligned qkv")
    t = qkv.shape[0]
    length = t // batch
    with trace.span("op.qk_norm_rope", device=True) as sp:
        if sp.on:
            sp.set(rows=t, length=length, heads=heads, kv_heads=kv_heads,
                   d=HEAD_DIM, itemsize=qkv.element_size())
        cos, sin = rope_tables(length, float(theta), qkv.device)
        scales = [w.to(device=qkv.device, dtype=qkv.dtype).contiguous()
                  for w in (q_scale, k_scale)]
        q = torch.empty((batch, heads, length, HEAD_DIM), device=qkv.device,
                        dtype=qkv.dtype)
        k = torch.empty((batch, kv_heads, length, HEAD_DIM),
                        device=qkv.device, dtype=qkv.dtype)
        v = torch.empty_like(k)
        if t:
            lib = _build.library()
            err = lib.kx_qk_norm_rope(
                qkv.data_ptr(), scales[0].data_ptr(), scales[1].data_ptr(),
                cos.data_ptr(), sin.data_ptr(), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), t, length, heads, kv_heads, float(eps),
                torch.cuda.current_stream(qkv.device).cuda_stream)
            _build.check(lib, err, "kx_qk_norm_rope launch")
            qk_norm_rope.launches += 1
        return q, k, v


# kernel launches on CUDA tensors (plain-version calls are not counted)
qk_norm_rope.launches = 0
