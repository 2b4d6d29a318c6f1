"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward) and
``csrc/flash_bwd.cu`` (the rotation pass of the forward, the backward's
pre-pass, dK/dV and dQ), each with its plain PyTorch version (counterpart of
kosmosx_tpu/ops/flash_attention.py).

Semantics of kosmosx_tpu/ops/flash_attention.py:663-715:

- q (B, H, Lq, D), k/v (B, H, Lk, D); causal masking aligned at the top left
  (query i sees keys j <= i), as the TPU kernel's tile mask (:156-167);
- grouped-query attention in the forward: k/v may hold Hkv heads, Hkv
  dividing H, query head h reading key/value head ``h // (H // Hkv)``; the
  kernel reads them in place (no repeat), the plain version repeats them.
  The backward and xPos take Hkv = H only;
- segment ids (B, Lq)/(B, Lk): positions attend only within equal ids;
- ``xpos_scale_base`` applies xPos inside the op: pass un-rotated q/k; the
  tables are centred at ``xpos_center`` (default ``Lq // 2``, :707-708) and
  the rotated rows are rounded to the input dtype before the product, as
  ``_apply_rot`` does (:142-147). In bf16 on the card one pass rotates q
  (with ``sm_scale * log2(e)`` folded into its tables) and k once
  (``flash_fwd_prep``), and the forward kernel streams q' and k';
- the softmax runs in the log2 domain with ``sm_scale * log2(e)`` folded in,
  so the statistics ``l`` (sum of exp2) and ``m`` (row max) returned by
  ``flash_attention_fwd`` are in log2 units, shape (B, H, Lq) fp32. The
  backward consumes them, as the ring attention of a later PR will;
- ``flash_attention`` is differentiable (the custom VJP of :609-651): its
  backward runs the pre-pass (``di = rowsum(o * do)`` and, with xPos, q and
  k rotated once), then recomputes p from (l, m) in the dK/dV and dQ
  kernels, or the plain versions of all three for CPU tensors. The xPos
  rule of the backward is the JAX one, stated in ``csrc/flash_bwd.cu``: raw
  tables, the scores scaled by ``sm_scale * log2(e)`` after the product, dq
  and dk mapped back through the rotation's transpose.

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
from kosmosx_torch.utils import trace

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


def whole_tiles(b, lq, lk, causal, q_segment_ids=None, kv_segment_ids=None,
                rows=16, cols=64) -> torch.Tensor:
    """The kernels' test for a tile that takes no mask
    (``csrc/flash_common.cuh::tile_whole``) in plain torch: (B, ceil(Lq /
    rows), ceil(Lk / cols)) bool, True where the ``rows`` q rows of a warp
    see every entry of a ``cols``-column kv tile. The tile lies inside Lk
    and, under causal masking, at or below the diagonal for the warp's first
    row; with segment ids, the warp's rows (id -1 past Lq) and the tile's
    columns (-2 past Lk) hold one and the same id."""
    nr, nc = -(-lq // rows), -(-lk // cols)
    r0 = torch.arange(nr)[:, None] * rows
    k0 = torch.arange(nc)[None, :] * cols
    inside = k0 + cols <= lk
    if causal:
        inside = inside & (k0 + cols - 1 <= r0)
    inside = inside.expand(b, nr, nc)
    if q_segment_ids is None:
        return inside

    def groups(ids, n, size, pad):
        ids = torch.nn.functional.pad(ids.to(torch.int64).cpu(),
                                      (0, n * size - ids.shape[1]), value=pad)
        ids = ids.reshape(ids.shape[0], n, size)
        return (ids == ids[..., :1]).all(-1), ids[..., 0]

    q_one, q_id = groups(q_segment_ids, nr, rows, -1)
    k_one, k_id = groups(kv_segment_ids, nc, cols, -2)
    return inside & q_one[:, :, None] & k_one[:, None, :] & \
        (q_id[:, :, None] == k_id[:, None, :])


def flash_fwd_prep_plain(q, k, *, sm_scale=1.0, xpos_scale_base=None,
                         xpos_center=None, **_):
    """The forward's rotation in plain torch: ``(q', k')``, q rotated with
    the q tables times ``sm_scale * log2(e)`` and k with the downscaled k
    tables, each rounded to its dtype (kosmosx_tpu/ops/flash_attention.py:
    247-251, 194-197); q and k themselves without xPos."""
    if xpos_scale_base is None:
        return q, k
    q_sin, q_cos, k_sin, k_cos = _tables(q.shape[2], k.shape[2], q.shape[3],
                                         xpos_scale_base, xpos_center,
                                         sm_scale * LOG2E, q.device)
    return _rotate(q, q_sin, q_cos), _rotate(k, k_sin, k_cos)


def flash_attention_plain(q, k, v, *, causal=True, sm_scale=1.0,
                          q_segment_ids=None, kv_segment_ids=None,
                          xpos_scale_base=None, xpos_center=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch, fp32 math: (o, l, m). With
    xPos, the scores are q' k'^T of ``flash_fwd_prep_plain``, which carries
    the scale."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    if xpos_scale_base is not None:
        q_r, k_r = flash_fwd_prep_plain(q, k, sm_scale=sm_scale,
                                        xpos_scale_base=xpos_scale_base,
                                        xpos_center=xpos_center)
        s = q_r.float() @ k_r.float().transpose(-1, -2)
    else:
        s = (q.float() @ k.float().transpose(-1, -2)) * (sm_scale * LOG2E)
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


def _repeat_kv(t: torch.Tensor, h: int) -> torch.Tensor:
    """k or v of Hkv heads as H heads: each key/value head repeated for the
    H // Hkv query heads that read it (the plain version of the kernel's
    head mapping)."""
    return t if t.shape[1] == h else t.repeat_interleave(h // t.shape[1], 1)


def _rotate_t(g: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """Transpose of the xPos rotation on an fp32 gradient:
    ``g * cos - rotate_every_two(g * sin)`` (``_apply_rot_transpose``,
    kosmosx_tpu/ops/flash_attention.py:150-153)."""
    return g * cos - rotate_every_two(g * sin)


def _recompute(q, k, v, l, m, di, do, *, causal=True, sm_scale=1.0,
               q_segment_ids=None, kv_segment_ids=None, xpos_scale_base=None,
               xpos_center=None):
    """What both backward kernels recompute, in fp32 from the residuals
    (``_recompute_p`` and the bodies of ``_bwd_dkv_kernel`` /
    ``_bwd_dq_kernel``, kosmosx_tpu/ops/flash_attention.py:333-464): q' and
    k' rotated with the raw tables and rounded to the input dtype, p from
    (l, m) with the scores scaled after the product, dS = p (dP - di)
    sm_scale (0 where masked), and the raw tables (or None)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    tables = None
    if xpos_scale_base is not None:
        center = lq // 2 if xpos_center is None else xpos_center
        tables = _tables(lq, lk, d, xpos_scale_base, center, 1.0, q.device)
        q_r = _rotate(q, tables[0], tables[1]).float()
        k_r = _rotate(k, tables[2], tables[3]).float()
    else:
        q_r, k_r = q.float(), k.float()
    s = (q_r @ k_r.transpose(-1, -2)) * (sm_scale * LOG2E)
    mask = _mask(b, lq, lk, causal, q_segment_ids, kv_segment_ids, q.device)
    inv_l = torch.where(l == 0.0, 1.0, 1.0 / l)
    p = torch.exp2(s - m[..., None]) * inv_l[..., None]
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    do32 = do.float()
    ds = p * (do32 @ v.float().transpose(-1, -2) - di[..., None]) * sm_scale
    return q_r, k_r, p, ds, do32, tables


def flash_bwd_dkv_plain(q, k, v, l, m, di, do, **kw):
    """``_bwd_dkv_kernel`` in plain torch, fp32 math: (dk, dv) in k's and
    v's dtype. ``di`` = rowsum(o * do), (B, H, Lq) fp32."""
    q_r, _, p, ds, do32, tables = _recompute(q, k, v, l, m, di, do, **kw)
    dv = p.transpose(-1, -2) @ do32
    dk = ds.transpose(-1, -2) @ q_r
    if tables is not None:
        dk = _rotate_t(dk, tables[2], tables[3])
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, l, m, di, do, **kw):
    """``_bwd_dq_kernel`` in plain torch, fp32 math: dq in q's dtype."""
    _, k_r, _, ds, _, tables = _recompute(q, k, v, l, m, di, do, **kw)
    dq = ds @ k_r
    if tables is not None:
        dq = _rotate_t(dq, tables[0], tables[1])
    return dq.to(q.dtype)


def _di(o, do):
    """rowsum(o * do) in fp32 (kosmosx_tpu/ops/flash_attention.py:476)."""
    return (o.float() * do.float()).sum(-1)


def flash_bwd_prep_plain(q, k, o, do, *, xpos_scale_base=None, xpos_center=None,
                         **_):
    """The backward pre-pass in plain torch: ``(q', k', di)``, q and k rotated
    with the raw xPos tables and rounded to their dtype (q and k themselves
    without xPos), ``di`` = rowsum(o * do) in fp32, (B, H, Lq)."""
    di = _di(o, do)
    if xpos_scale_base is None:
        return q, k, di
    center = q.shape[2] // 2 if xpos_center is None else xpos_center
    q_sin, q_cos, k_sin, k_cos = _raw_tables(q, k, xpos_scale_base, center)
    return _rotate(q, q_sin, q_cos), _rotate(k, k_sin, k_cos), di


def flash_attention_bwd_plain(q, k, v, o, l, m, do, **kw):
    """The backward kernels' functions in plain torch, fp32 math, from the
    forward's residuals ``(o, l, m)``: (dq, dk, dv). Keyword arguments as
    ``flash_attention_fwd``."""
    _, _, di = flash_bwd_prep_plain(q, k, o, do, **kw)
    dk, dv = flash_bwd_dkv_plain(q, k, v, l, m, di, do, **kw)
    return flash_bwd_dq_plain(q, k, v, l, m, di, do, **kw), dk, dv


def _check_cuda_inputs(q, k, v, q_segment_ids, kv_segment_ids, *,
                       grouped=False):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name} must match q's device and dtype; got "
                            f"{t.device}/{t.dtype} vs {q.device}/{q.dtype}")
    b, h, lq, d = q.shape
    heads_ok = k.shape[1] == h or (grouped and 0 < k.shape[1]
                                   and h % k.shape[1] == 0)
    if k.shape != v.shape or k.shape[0] != b or not heads_ok \
            or k.shape[3] != d:
        want = "Hkv dividing H" if grouped else "H"
        raise ValueError(f"k/v must be (B, {want}, Lk, D) matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
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


def _fwd_prep_cuda(q, k, *, sm_scale, xpos_scale_base, xpos_center, **_):
    """Launch the forward's rotation (``kx_flash_fwd_prep``, bf16): (q', k')
    with the forward's tables."""
    from kosmosx_torch.ops import _build

    _check_cuda_inputs(q, k, k, None, None)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the forward's rotation kernel takes bfloat16, got "
                        f"{q.dtype}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    tables = _tables(lq, lk, d, xpos_scale_base, xpos_center,
                     sm_scale * LOG2E, q.device)
    q_r, k_r = torch.empty_like(q), torch.empty_like(k)
    lib = _build.library()
    err = lib.kx_flash_fwd_prep(
        q.data_ptr(), k.data_ptr(), *(t.data_ptr() for t in tables),
        q_r.data_ptr(), k_r.data_ptr(), b, h, lq, lk, d,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "kx_flash_fwd_prep launch")
    flash_fwd_prep.launches += 1
    return q_r, k_r


def _fwd_kernel_cuda(q, k, v, *, causal, scale, q_segment_ids, kv_segment_ids,
                     tables=(None,) * 4):
    """Launch ``kx_flash_fwd`` on q and k as given, the scores times
    ``scale``: (o, l, m). The bf16 kernel takes no tables."""
    from kosmosx_torch.ops import _build

    b, h, lq, d = q.shape
    lk = k.shape[2]
    segs = _segs(q_segment_ids, kv_segment_ids)
    o = torch.empty_like(q)
    l = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    m = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    lib = _build.library()
    err = lib.kx_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(segs[0]), _ptr(segs[1]),
        *(_ptr(t) for t in tables), o.data_ptr(), l.data_ptr(), m.data_ptr(),
        b, h, k.shape[1], lq, lk, d, _DTYPE_CODES[q.dtype], int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_fwd launch")
    flash_attention.launches += 1
    return o, l, m


def _flash_cuda(q, k, v, *, causal, sm_scale, q_segment_ids, kv_segment_ids,
                xpos_scale_base, xpos_center):
    """Under xPos the bf16 kernel reads q' and k' from the rotation kernel,
    and the fp32 kernel rotates raw q and k itself from the tables; either
    way the q side carries ``sm_scale * log2(e)``. k and v may hold fewer
    heads than q without xPos."""
    _check_cuda_inputs(q, k, v, q_segment_ids, kv_segment_ids,
                       grouped=xpos_scale_base is None)
    c = sm_scale * LOG2E
    kw = dict(causal=causal, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids)
    if xpos_scale_base is None:
        return _fwd_kernel_cuda(q, k, v, scale=c, **kw)
    if q.dtype == torch.bfloat16:
        q_r, k_r = _fwd_prep_cuda(q, k, sm_scale=sm_scale,
                                  xpos_scale_base=xpos_scale_base,
                                  xpos_center=xpos_center)
        return _fwd_kernel_cuda(q_r, k_r, v, scale=1.0, **kw)
    tables = _tables(q.shape[2], k.shape[2], q.shape[3], xpos_scale_base,
                     xpos_center, c, q.device)
    return _fwd_kernel_cuda(q, k, v, scale=1.0, tables=tables, **kw)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _segs(q_segment_ids, kv_segment_ids):
    if q_segment_ids is None:
        return None, None
    return (q_segment_ids.to(torch.int32).contiguous(),
            kv_segment_ids.to(torch.int32).contiguous())


def _check_bwd_inputs(q, k, v, l, m, di, do, q_segment_ids, kv_segment_ids):
    _check_cuda_inputs(q, k, v, q_segment_ids, kv_segment_ids)
    b, h, lq, _ = q.shape
    _check_like_q(q, "do", do)
    for name, t in (("l", l), ("m", m), ("di", di)):
        if tuple(t.shape) != (b, h, lq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({b}, {h}, {lq}) "
                             f"float32 tensor on {q.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _raw_tables(q, k, xpos_scale_base, xpos_center):
    """The raw xPos tables (q_sin, q_cos, k_sin, k_cos), or four Nones."""
    if xpos_scale_base is None:
        return (None,) * 4
    return _tables(q.shape[2], k.shape[2], q.shape[3], xpos_scale_base,
                   xpos_center, 1.0, q.device)


def _check_like_q(q, name, t):
    if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"{tuple(q.shape)} {q.dtype} tensor on {q.device}; "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _prep_cuda(q, k, o, do, *, rotate, xpos_scale_base, xpos_center, **_):
    """Launch the pre-pass (``kx_flash_bwd_prep``): ``di`` when ``o`` is
    given, q' and k' when ``rotate`` and xPos is on. Returns (q', k', di),
    with q and k themselves where nothing rotates and None for no di."""
    from kosmosx_torch.ops import _build

    _check_cuda_inputs(q, k, k, None, None)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    rotate = rotate and xpos_scale_base is not None
    tables = (_raw_tables(q, k, xpos_scale_base, xpos_center) if rotate
              else (None,) * 4)
    q_r, k_r = (torch.empty_like(q), torch.empty_like(k)) if rotate else (q, k)
    di = None
    if o is not None:
        _check_like_q(q, "o", o)
        _check_like_q(q, "do", do)
        di = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    if not rotate and di is None:
        return q, k, None
    lib = _build.library()
    err = lib.kx_flash_bwd_prep(
        q.data_ptr(), k.data_ptr(), _ptr(o), _ptr(do), *(_ptr(t) for t in tables),
        _ptr(q_r) if rotate else None, _ptr(k_r) if rotate else None, _ptr(di),
        b, h, lq, lk, d, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "kx_flash_bwd_prep launch")
    flash_bwd_prep.launches += 1
    return q_r, k_r, di


def _bwd_cuda(entry, outs, q, k, v, l, m, di, do, *, rotated, causal, sm_scale,
              q_segment_ids, kv_segment_ids, xpos_scale_base, xpos_center):
    """Launch one backward kernel (``kx_flash_bwd_dkv`` or ``kx_flash_bwd_dq``)
    writing into ``outs``. The bf16 kernels read q' and k': ``rotated`` from
    the caller's pre-pass, else the pre-pass runs here (with xPos only). The
    fp32 kernels rotate raw q and k themselves."""
    from kosmosx_torch.ops import _build

    _check_bwd_inputs(q, k, v, l, m, di, do, q_segment_ids, kv_segment_ids)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    tables = _raw_tables(q, k, xpos_scale_base, xpos_center)
    qk = (q, k)
    if q.dtype == torch.bfloat16 and xpos_scale_base is not None:
        qk = rotated if rotated is not None else _prep_cuda(
            q, k, None, None, rotate=True, xpos_scale_base=xpos_scale_base,
            xpos_center=xpos_center)[:2]
    segs = _segs(q_segment_ids, kv_segment_ids)
    lib = _build.library()
    err = getattr(lib, entry)(
        qk[0].data_ptr(), qk[1].data_ptr(), v.data_ptr(), do.data_ptr(),
        l.data_ptr(), m.data_ptr(), di.data_ptr(), _ptr(segs[0]), _ptr(segs[1]),
        *(_ptr(t) for t in tables), *(t.data_ptr() for t in outs),
        b, h, lq, lk, d, _DTYPE_CODES[q.dtype], int(causal),
        sm_scale * LOG2E, sm_scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, f"{entry} launch")


def _dispatch(q, plain, kernel, *args, **kw):
    if q.device.type == "cpu":
        return plain(*args, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    return kernel(*args, **kw)


def _dkv_cuda(q, k, v, l, m, di, do, rotated=None, **kw):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_cuda("kx_flash_bwd_dkv", (dk, dv), q, k, v, l, m, di, do,
              rotated=rotated, **kw)
    flash_bwd_dkv.launches += 1
    return dk, dv


def _dq_cuda(q, k, v, l, m, di, do, rotated=None, **kw):
    dq = torch.empty_like(q)
    _bwd_cuda("kx_flash_bwd_dq", (dq,), q, k, v, l, m, di, do,
              rotated=rotated, **kw)
    flash_bwd_dq.launches += 1
    return dq


def _resolve(q, q_segment_ids=None, kv_segment_ids=None, causal=True,
             sm_scale=1.0, xpos_scale_base=None, xpos_center=None):
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids, or neither")
    if xpos_scale_base is not None and xpos_center is None:
        xpos_center = q.shape[2] // 2  # torchscale full-sequence centering
    return dict(causal=causal, sm_scale=float(sm_scale),
                q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                xpos_scale_base=xpos_scale_base, xpos_center=xpos_center)


def flash_bwd_prep(q, k, o, do, **kw):
    """The backward pre-pass ``(q', k', di)`` of ``flash_bwd_prep_plain``:
    the plain version for CPU tensors, the pre-pass kernel of
    ``csrc/flash_bwd.cu`` for CUDA tensors (or raise). Keyword arguments as
    ``flash_attention_fwd``."""
    return _dispatch(q, flash_bwd_prep_plain,
                     functools.partial(_prep_cuda, rotate=True), q, k, o, do,
                     **_resolve(q, **kw))


def flash_fwd_prep(q, k, **kw):
    """The forward's rotation ``(q', k')`` of ``flash_fwd_prep_plain``: the
    plain version for CPU tensors, the rotation kernel (``kx_flash_fwd_prep``
    of ``csrc/flash_bwd.cu``) for bf16 CUDA tensors (or raise); q and k
    themselves without xPos. Keyword arguments as ``flash_attention_fwd``."""
    kw = _resolve(q, **kw)
    if kw["xpos_scale_base"] is None and q.device.type in ("cpu", "cuda"):
        return q, k
    return _dispatch(q, flash_fwd_prep_plain, _fwd_prep_cuda, q, k, **kw)


def flash_bwd_dkv(q, k, v, l, m, di, do, **kw):
    """dK/dV from the residuals and ``di`` = rowsum(o * do): the plain
    version for CPU tensors, the kernel of ``csrc/flash_bwd.cu`` for CUDA
    tensors (or raise); a bf16 call with xPos runs the pre-pass first for
    q' and k'. Keyword arguments as ``flash_attention_fwd``."""
    return _dispatch(q, flash_bwd_dkv_plain, _dkv_cuda, q, k, v, l, m, di, do,
                     **_resolve(q, **kw))


def flash_bwd_dq(q, k, v, l, m, di, do, **kw):
    """dQ from the residuals; dispatch as ``flash_bwd_dkv``."""
    return _dispatch(q, flash_bwd_dq_plain, _dq_cuda, q, k, v, l, m, di, do,
                     **_resolve(q, **kw))


def flash_attention_fwd(q, k, v, *, causal: bool = True, sm_scale: float = 1.0,
                        q_segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        xpos_scale_base: Optional[float] = None,
                        xpos_center: Optional[int] = None):
    """Flash-attention forward returning ``(o, l, m)``; not differentiable.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel of
    ``csrc/flash_fwd.cu`` (built at first use), in bf16 with xPos after the
    rotation kernel, or raises."""
    kw = _resolve(q, q_segment_ids, kv_segment_ids, causal, sm_scale,
                  xpos_scale_base, xpos_center)
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash attention needs non-empty q and k")
    with trace.span("op.flash_fwd", device=True) as sp:
        if sp.on:
            sp.set(**_span_shapes(q, k, causal))
        return _dispatch(q, flash_attention_plain, _flash_cuda, q, k, v, **kw)


def flash_attention_bwd(q, k, v, o, l, m, do, *, causal: bool = True,
                        sm_scale: float = 1.0,
                        q_segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        xpos_scale_base: Optional[float] = None,
                        xpos_center: Optional[int] = None):
    """Flash-attention backward from the forward's residuals: (dq, dk, dv).
    CPU tensors run the plain versions; CUDA tensors run the pre-pass once
    (``di`` and, in bf16 with xPos, q' and k'), then the dK/dV and dQ
    kernels of ``csrc/flash_bwd.cu`` on its outputs (or raise)."""
    kw = _resolve(q, q_segment_ids, kv_segment_ids, causal, sm_scale,
                  xpos_scale_base, xpos_center)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    with trace.span("op.flash_bwd", device=True) as sp:
        if sp.on:
            sp.set(**_span_shapes(q, k, causal))
        do = do.contiguous()
        if q.device.type == "cpu":
            return flash_attention_bwd_plain(q, k, v, o, l, m, do, **kw)
        q_r, k_r, di = _prep_cuda(q, k, o, do,
                                  rotate=q.dtype == torch.bfloat16, **kw)
        dk, dv = _dkv_cuda(q, k, v, l, m, di, do, rotated=(q_r, k_r), **kw)
        return _dq_cuda(q, k, v, l, m, di, do, rotated=(q_r, k_r), **kw), \
            dk, dv


def _span_shapes(q, k, causal) -> dict:
    """A flash call's shapes for its span: q (b, h, lq, d), k's heads and
    length, the mask and the element size."""
    b, h, lq, d = q.shape
    return dict(b=b, h=h, lq=lq, d=d, lk=k.shape[2], causal=bool(causal),
                itemsize=q.element_size(), kv_heads=k.shape[1])


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the custom VJP of
    kosmosx_tpu/ops/flash_attention.py:609-651. The forward saves (q, k, v,
    segment ids, o, l, m); the backward returns dq, dk, dv."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, causal, sm_scale,
                xpos_scale_base, xpos_center):
        kw = dict(causal=causal, sm_scale=sm_scale,
                  xpos_scale_base=xpos_scale_base, xpos_center=xpos_center)
        o, l, m = flash_attention_fwd(q, k, v, q_segment_ids=q_segment_ids,
                                      kv_segment_ids=kv_segment_ids, **kw)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, o, l, m)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, o, l, m = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, l, m, do,
                                         q_segment_ids=q_seg,
                                         kv_segment_ids=kv_seg, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, sm_scale: float = 1.0,
                    q_segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    xpos_scale_base: Optional[float] = None,
                    xpos_center: Optional[int] = None) -> torch.Tensor:
    """Differentiable flash attention over (B, H, L, D) tensors; returns o in
    q's dtype. Keyword arguments as ``flash_attention_fwd``."""
    return FlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids,
                                causal, float(sm_scale), xpos_scale_base,
                                xpos_center)


# kernel launches on CUDA tensors (plain-version calls are not counted)
flash_attention.launches = 0
flash_fwd_prep.launches = 0
flash_bwd_prep.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
