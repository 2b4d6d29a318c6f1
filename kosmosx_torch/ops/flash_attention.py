"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain PyTorch version (counterpart of kosmosx_tpu/ops/flash_attention.py).

Semantics of kosmosx_tpu/ops/flash_attention.py:663-715 (the forward only;
the backward kernels belong to training, ROADMAP.md Queue 2 items 2-3):

- q (B, H, Lq, D), k/v (B, H, Lk, D); causal masking aligned at the top left
  (query i sees keys j <= i), as the TPU kernel's tile mask (:156-167);
- segment ids (B, Lq)/(B, Lk): positions attend only within equal ids;
- ``xpos_scale_base`` fuses xPos into the kernel: pass un-rotated q/k; the
  tables are centred at ``xpos_center`` (default ``Lq // 2``, :707-708) and
  the rotated rows are rounded to the input dtype before the product, as
  ``_apply_rot`` does (:142-147);
- the softmax runs in the log2 domain with ``sm_scale * log2(e)`` folded in,
  so the statistics ``l`` (sum of exp2) and ``m`` (row max) returned by
  ``flash_attention_fwd`` are in log2 units, shape (B, H, Lq) fp32. The
  backward and the ring attention of later PRs consume them.

A masked score takes ``MASK_VALUE`` for the row max and adds nothing to the
row: a query with no visible key returns 0 (``l == 0`` -> 1/l taken as 1,
:227-230). The TPU kernel instead spreads such a row uniformly over the keys
of the tiles it visited; every caller discards those rows.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from kosmosx_torch.nn.xpos import rotate_every_two, xpos_tables

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LOG2E = 1.4426950408889634
# the kernels' head dims: the flagship decoder's
HEAD_DIMS = (64,)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """xPos rotation from fp32 tables, rounded back to x's dtype."""
    x32 = x.float()
    return (x32 * cos + rotate_every_two(x32) * sin).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _tables(lq, lk, d, scale_base, center, c, device):
    """(q_sin, q_cos, k_sin, k_cos) (L, D) fp32, with ``c = sm_scale *
    log2(e)`` folded into the q side (kosmosx_tpu/ops/flash_attention.py:
    122-139, 247-251). Cached: every layer of a forward asks for the same
    tables, and building them takes some forty small launches. Callers only
    read them."""
    q_sin, q_cos = xpos_tables(lq, d, scale_base=scale_base, center=center,
                               device=device)
    k_sin, k_cos = xpos_tables(lk, d, scale_base=scale_base, center=center,
                               downscale=True, device=device)
    return q_sin * c, q_cos * c, k_sin, k_cos


def _mask(b, lq, lk, causal, q_segment_ids, kv_segment_ids, device):
    mask = None
    if causal:
        rows = torch.arange(lq, device=device)[:, None]
        cols = torch.arange(lk, device=device)[None, :]
        mask = (cols <= rows)[None, None]
    if q_segment_ids is not None:
        seg = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        mask = seg if mask is None else mask & seg
    return mask


def flash_attention_plain(q, k, v, *, causal=True, sm_scale=1.0,
                          q_segment_ids=None, kv_segment_ids=None,
                          xpos_scale_base=None, xpos_center=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch, fp32 math: (o, l, m)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    c = sm_scale * LOG2E
    if xpos_scale_base is not None:
        q_sin, q_cos, k_sin, k_cos = _tables(lq, lk, d, xpos_scale_base,
                                             xpos_center, c, q.device)
        s = _rotate(q, q_sin, q_cos).float() @ \
            _rotate(k, k_sin, k_cos).float().transpose(-1, -2)
    else:
        s = (q.float() @ k.float().transpose(-1, -2)) * c
    mask = _mask(b, lq, lk, causal, q_segment_ids, kv_segment_ids, q.device)
    if mask is not None:
        s = torch.where(mask, s, MASK_VALUE)
    m = s.amax(dim=-1)
    p = torch.exp2(s - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    inv = torch.where(l == 0.0, 1.0, 1.0 / l)
    o = (p @ v.float()) * inv[..., None]
    return o.to(q.dtype), l, m


def _check_cuda_inputs(q, k, v, q_segment_ids, kv_segment_ids):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name} must match q's device and dtype; got "
                            f"{t.device}/{t.dtype} vs {q.device}/{q.dtype}")
    b, h, lq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k/v must be (B, H, Lk, D) matching q {tuple(q.shape)};"
                         f" got {tuple(k.shape)} / {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel head dim must be one of {HEAD_DIMS}, "
                         f"got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs a contiguous, 16-byte "
                             f"aligned {name}")
    if q_segment_ids is not None:
        for name, t, length in (("q_segment_ids", q_segment_ids, lq),
                                ("kv_segment_ids", kv_segment_ids, k.shape[2])):
            if t.device != q.device or tuple(t.shape) != (b, length):
                raise ValueError(f"{name} must be ({b}, {length}) on "
                                 f"{q.device}; got {tuple(t.shape)} on "
                                 f"{t.device}")


def _flash_cuda(q, k, v, *, causal, sm_scale, q_segment_ids, kv_segment_ids,
                xpos_scale_base, xpos_center):
    from kosmosx_torch.ops import _build

    _check_cuda_inputs(q, k, v, q_segment_ids, kv_segment_ids)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    c = sm_scale * LOG2E
    tables = (None,) * 4
    if xpos_scale_base is not None:
        tables = _tables(lq, lk, d, xpos_scale_base, xpos_center, c, q.device)
    segs = (None, None)
    if q_segment_ids is not None:
        segs = (q_segment_ids.to(torch.int32).contiguous(),
                kv_segment_ids.to(torch.int32).contiguous())
    o = torch.empty_like(q)
    l = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    m = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.library()
    err = lib.kx_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(segs[0]), ptr(segs[1]),
        *(ptr(t) for t in tables), o.data_ptr(), l.data_ptr(), m.data_ptr(),
        b, h, lq, lk, d, _DTYPE_CODES[q.dtype], int(causal), c,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_fwd launch")
    flash_attention.launches += 1
    return o, l, m


def flash_attention_fwd(q, k, v, *, causal: bool = True, sm_scale: float = 1.0,
                        q_segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        xpos_scale_base: Optional[float] = None,
                        xpos_center: Optional[int] = None):
    """Flash-attention forward returning ``(o, l, m)``.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel of
    ``csrc/flash_fwd.cu`` (built at first use) or raises."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids, or neither")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash attention needs non-empty q and k")
    if xpos_scale_base is not None and xpos_center is None:
        xpos_center = q.shape[2] // 2  # torchscale full-sequence centering
    kw = dict(causal=causal, sm_scale=float(sm_scale),
              q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              xpos_scale_base=xpos_scale_base, xpos_center=xpos_center)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    return _flash_cuda(q, k, v, **kw)


def flash_attention(q, k, v, **kw) -> torch.Tensor:
    """Flash attention over (B, H, L, D) tensors; returns o in q's dtype.
    Keyword arguments as ``flash_attention_fwd``."""
    return flash_attention_fwd(q, k, v, **kw)[0]


# kernel launches on CUDA tensors (plain-version calls are not counted)
flash_attention.launches = 0
