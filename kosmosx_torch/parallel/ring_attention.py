"""Ring flash attention over a ``sequence`` process group: context
parallelism (counterpart of kosmosx_tpu/parallel/ring_attention.py).

The sequence is sharded over the ranks of a group; each rank keeps its q
shard and the K/V shards travel round the ring (``comm.shift``, one
``batch_isend_irecv`` step per hop) while the per-pair flash partials are
merged with the log-sum-exp combine. Both schedules run the port's flash
kernels (``ops/flash_attention``: ``flash_attention_fwd`` for each pair, the
backward's pre-pass once, then ``flash_bwd_dkv`` and ``flash_bwd_dq`` for
each pair), so a CUDA tensor never takes a plain version; a CPU tensor
takes the kernels' plain versions, as everywhere in the port.

- ``ring_flash_attention``: contiguous shards. Step 0 runs the causal
  kernel on the local pair; step r > 0 the non-causal kernel against the
  shard from rank ``i - r``. Under causal masking a pair with ``i < r``
  lies above the diagonal: JAX computes it and discards it (``_gate``,
  :96-99); here the rank knows ``i`` and ``r`` on the host and skips the
  call, so rank S - 1 does S times rank 0's work.
- ``zigzag_ring_flash_attention``: the load-balanced causal schedule. The
  global sequence is cut into 2S chunks and rank ``i`` holds chunks ``i``
  and ``2S - 1 - i`` (``zigzag_permute``). Step 0 runs three calls (the
  two halves causal, the high half against the low one), every later step
  two: the high half against the low one, and one selected pair, the low
  halves where ``i > j`` and the high ones where ``i < j``. JAX computes
  both candidates of the selected pair with ``jnp.where`` (:346-357); here
  the unselected one is never launched.

Backward: the ring rotates K, V, the K segment ids and the fp32 dK/dV
accumulators together; each rank adds its pairs' contributions while it
holds a shard, and one last shift returns the accumulators to their
owners. Each pair recomputes its probabilities from the GLOBAL statistics
``(l, m)`` of the merged forward, and ``di = rowsum(o * do)`` is computed
once per ring backward on the global ``o`` (``flash_bwd_prep``).

The statistics of the port's kernels are ``(B, H, L)`` fp32 in the log2
domain (the kernels' exp2 softmax with ``sm_scale * log2(e)`` folded in),
and a query with no visible key comes back with ``l == 0``; ``_merge``
combines in that domain. xPos depends on absolute positions: rotate q and
k with each shard's (zigzag: each half's) global offset before calling
(``nn/attention.py`` does), and the kernels run without it.
"""

from __future__ import annotations

from typing import Optional

import torch

from kosmosx_torch.ops.flash_attention import (flash_attention_fwd,
                                               flash_bwd_dkv, flash_bwd_dq,
                                               flash_bwd_prep)
from kosmosx_torch.parallel.comm import group_rank, group_size, shift


def _merge(o1, l1, m1, o2, l2, m2):
    """Combine two NORMALIZED flash partials (kosmosx_tpu/parallel/
    ring_attention.py:58-71): o fp32 (..., L, D), statistics (..., L) fp32
    in the log2 domain. A row neither partial has covered (``m`` -inf) or
    whose partial saw no key (``l`` 0) adds nothing."""
    m = torch.maximum(m1, m2)
    msafe = torch.where(torch.isneginf(m), 0.0, m)
    a1 = torch.where(torch.isneginf(m1), 0.0, torch.exp2(m1 - msafe))
    a2 = torch.where(torch.isneginf(m2), 0.0, torch.exp2(m2 - msafe))
    w1 = l1 * a1
    w2 = l2 * a2
    l = w1 + w2
    inv = torch.where(l == 0.0, 1.0, 1.0 / l)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) * inv[..., None]
    return o, l, m


def _empty_acc(b, h, length, d, device):
    return (torch.zeros((b, h, length, d), device=device),
            torch.zeros((b, h, length), device=device),
            torch.full((b, h, length), -torch.inf, device=device))


def _fwd_pair(q, k, v, qs, ks, causal, sm_scale):
    """One flash forward call: (o fp32, l, m)."""
    o, l, m = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                  q_segment_ids=qs, kv_segment_ids=ks)
    return o.float(), l, m


def _bwd_pair(q, k, v, qs, ks, l, m, di, do, causal, sm_scale):
    """One pair's backward from the global statistics: (dq, dk, dv) fp32."""
    kw = dict(causal=causal, sm_scale=sm_scale, q_segment_ids=qs,
              kv_segment_ids=ks)
    dk, dv = flash_bwd_dkv(q, k, v, l, m, di, do, **kw)
    dq = flash_bwd_dq(q, k, v, l, m, di, do, **kw)
    return dq.float(), dk.float(), dv.float()


def _halves(t: Optional[torch.Tensor], dim: int = 2):
    """The two halves of ``t`` along ``dim``, each made contiguous (the
    kernels take contiguous operands); (None, None) for None."""
    if t is None:
        return None, None
    c = t.shape[dim] // 2
    return (t.narrow(dim, 0, c).contiguous(),
            t.narrow(dim, c, c).contiguous())


def _check(q, k, v, q_segment_ids, kv_segment_ids):
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both segment-id tensors or neither")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2]:
        raise ValueError(f"k/v must be (B, H, Lk, D) like q {tuple(q.shape)}; "
                         f"got {tuple(k.shape)} / {tuple(v.shape)}")


# ---------------------------------------------------------------------------
# contiguous shards
# ---------------------------------------------------------------------------


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, group, causal, sm_scale):
        s, i = group_size(group), group_rank(group)
        b, h, lq, d = q.shape
        acc = _empty_acc(b, h, lq, d, q.device)
        kk, vv, ks = k, v, kseg
        for r in range(s):
            if not causal or r == 0 or i >= r:
                acc = _merge(*acc, *_fwd_pair(q, kk, vv, qseg, ks,
                                              causal and r == 0, sm_scale))
            if r != s - 1:
                kk, vv, ks = shift((kk, vv, ks), group)
        o = acc[0].to(q.dtype)
        ctx.save_for_backward(q, k, v, qseg, kseg, o, acc[1], acc[2])
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, qseg, kseg, o, l, m = ctx.saved_tensors
        group, causal, sm_scale = ctx.group, ctx.causal, ctx.sm_scale
        s, i = group_size(group), group_rank(group)
        do = do.contiguous()
        di = flash_bwd_prep(q, k, o, do)[2]
        dq = torch.zeros(q.shape, device=q.device)
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        kk, vv, ks = k, v, kseg
        for r in range(s):
            if not causal or r == 0 or i >= r:
                dq_c, dk_c, dv_c = _bwd_pair(q, kk, vv, qseg, ks, l, m, di, do,
                                             causal and r == 0, sm_scale)
                dq += dq_c
                dk += dk_c
                dv += dv_c
            if r != s - 1:
                kk, vv, ks, dk, dv = shift((kk, vv, ks, dk, dv), group)
        # shard j's accumulator sits on rank j - 1: one more hop home
        dk, dv = shift((dk, dv), group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def ring_flash_attention(q, k, v, group, *, causal: bool = True,
                         sm_scale: float = 1.0,
                         q_segment_ids: Optional[torch.Tensor] = None,
                         kv_segment_ids: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Flash attention with the sequence sharded over the process group
    ``group`` (JAX's ``axis_name``): ``q``/``k``/``v`` are this rank's
    (B, H, L/S, D) shards, contiguous shards in rank order; returns the
    local output shard. Differentiable. ``q_segment_ids``/
    ``kv_segment_ids``: this rank's (B, L/S) ids (padding, packed
    documents); the kv ids ride the ring with K/V. The TPU's lane and
    block rules (shard lengths % 128, ``block_q``/``block_kv``) are Pallas
    limits and are not carried over."""
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                       q_segment_ids, kv_segment_ids, group, bool(causal),
                       float(sm_scale))


# ---------------------------------------------------------------------------
# zigzag layout
# ---------------------------------------------------------------------------


def zigzag_chunk_order(s: int):
    """Global chunk order of the zigzag layout: rank d holds chunks
    (d, 2s-1-d) contiguously."""
    order = []
    for d in range(s):
        order += [d, 2 * s - 1 - d]
    return order


def _reorder(x: torch.Tensor, order, s: int, axis: int) -> torch.Tensor:
    length = x.shape[axis]
    if length % (2 * s):
        raise ValueError(f"length {length} does not split into {2 * s} "
                         f"zigzag chunks")
    c = length // (2 * s)
    shape = x.shape[:axis] + (2 * s, c) + x.shape[axis + 1:]
    idx = torch.as_tensor(order, device=x.device)
    return x.reshape(shape).index_select(axis, idx).reshape(x.shape)


def zigzag_permute(x: torch.Tensor, s: int, axis: int = 1) -> torch.Tensor:
    """Reorder a GLOBAL sequence axis into the zigzag layout, so that
    contiguous ``L/S`` shards hold chunks (d, 2s-1-d)."""
    return _reorder(x, zigzag_chunk_order(s), s, axis)


def zigzag_unpermute(x: torch.Tensor, s: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_permute`."""
    order = zigzag_chunk_order(s)
    inv = [0] * len(order)
    for pos, ch in enumerate(order):
        inv[ch] = pos
    return _reorder(x, inv, s, axis)


def zigzag_position_offsets(i: int, local_len: int, s: int,
                            device=None) -> torch.Tensor:
    """Per-position GLOBAL offsets (local_len,) int64 of rank ``i``'s
    zigzag shard: ``global_pos = offset + arange(local_len)``."""
    c = local_len // 2
    return torch.cat([torch.full((c,), i * c, dtype=torch.int64, device=device),
                      torch.full((c,), (2 * s - 1 - i) * c - c,
                                 dtype=torch.int64, device=device)])


class _Zigzag(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, group, sm_scale):
        s, i = group_size(group), group_rank(group)
        b, h, l2c, d = q.shape
        c = l2c // 2
        q_lo, q_hi = _halves(q)
        qs_lo, qs_hi = _halves(qseg, 1)
        acc_lo = _empty_acc(b, h, c, d, q.device)
        acc_hi = _empty_acc(b, h, c, d, q.device)

        def call(qc, kc, vc, qsc, ksc, causal):
            return _fwd_pair(qc, kc, vc, qsc, ksc, causal, sm_scale)

        kk, vv, ks = k, v, kseg
        for r in range(s):
            j = (i - r) % s
            k_lo, k_hi = _halves(kk)
            v_lo, v_hi = _halves(vv)
            ks_lo, ks_hi = _halves(ks, 1)
            if r == 0:
                # chunks (i, i) and (2s-1-i, 2s-1-i) causal, (2s-1-i, i) full
                acc_lo = _merge(*acc_lo, *call(q_lo, k_lo, v_lo, qs_lo, ks_lo,
                                               True))
                acc_hi = _merge(*acc_hi, *call(q_hi, k_hi, v_hi, qs_hi, ks_hi,
                                               True))
                acc_hi = _merge(*acc_hi, *call(q_hi, k_lo, v_lo, qs_hi, ks_lo,
                                               False))
            else:
                # always: (2s-1-i, j) full; then i > j: (i, j) into lo, or
                # i < j: (2s-1-i, 2s-1-j) into hi
                acc_hi = _merge(*acc_hi, *call(q_hi, k_lo, v_lo, qs_hi, ks_lo,
                                               False))
                if i > j:
                    acc_lo = _merge(*acc_lo, *call(q_lo, k_lo, v_lo, qs_lo,
                                                   ks_lo, False))
                else:
                    acc_hi = _merge(*acc_hi, *call(q_hi, k_hi, v_hi, qs_hi,
                                                   ks_hi, False))
            if r != s - 1:
                kk, vv, ks = shift((kk, vv, ks), group)
        o = torch.cat([acc_lo[0], acc_hi[0]], dim=2).to(q.dtype)
        l = torch.cat([acc_lo[1], acc_hi[1]], dim=2)
        m = torch.cat([acc_lo[2], acc_hi[2]], dim=2)
        ctx.save_for_backward(q, k, v, qseg, kseg, o, l, m)
        ctx.group, ctx.sm_scale = group, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, qseg, kseg, o, l, m = ctx.saved_tensors
        group, sm_scale = ctx.group, ctx.sm_scale
        s, i = group_size(group), group_rank(group)
        b, h, l2c, d = q.shape
        c = l2c // 2
        do = do.contiguous()
        di = flash_bwd_prep(q, k, o, do)[2]
        q_lo, q_hi = _halves(q)
        qs_lo, qs_hi = _halves(qseg, 1)
        lo = dict(zip(("l", "m", "di", "do"),
                      (_halves(t)[0] for t in (l, m, di, do))))
        hi = dict(zip(("l", "m", "di", "do"),
                      (_halves(t)[1] for t in (l, m, di, do))))
        for part in (lo, hi):
            for key in ("l", "m", "di"):
                part[key] = part[key].contiguous()
        dq_lo = torch.zeros((b, h, c, d), device=q.device)
        dq_hi = torch.zeros((b, h, c, d), device=q.device)
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)

        def add(qc, qsc, stats, kc, vc, ksc, causal, dq_acc, kv_half):
            dq_c, dk_c, dv_c = _bwd_pair(qc, kc, vc, qsc, ksc, stats["l"],
                                         stats["m"], stats["di"], stats["do"],
                                         causal, sm_scale)
            dq_acc += dq_c
            dk.narrow(2, kv_half * c, c).add_(dk_c)
            dv.narrow(2, kv_half * c, c).add_(dv_c)

        kk, vv, ks = k, v, kseg
        for r in range(s):
            j = (i - r) % s
            k_lo, k_hi = _halves(kk)
            v_lo, v_hi = _halves(vv)
            ks_lo, ks_hi = _halves(ks, 1)
            if r == 0:
                add(q_lo, qs_lo, lo, k_lo, v_lo, ks_lo, True, dq_lo, 0)
                add(q_hi, qs_hi, hi, k_hi, v_hi, ks_hi, True, dq_hi, 1)
                add(q_hi, qs_hi, hi, k_lo, v_lo, ks_lo, False, dq_hi, 0)
            else:
                add(q_hi, qs_hi, hi, k_lo, v_lo, ks_lo, False, dq_hi, 0)
                if i > j:
                    add(q_lo, qs_lo, lo, k_lo, v_lo, ks_lo, False, dq_lo, 0)
                else:
                    add(q_hi, qs_hi, hi, k_hi, v_hi, ks_hi, False, dq_hi, 1)
            if r != s - 1:
                kk, vv, ks, dk, dv = shift((kk, vv, ks, dk, dv), group)
        dk, dv = shift((dk, dv), group)
        dq = torch.cat([dq_lo, dq_hi], dim=2)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def zigzag_ring_flash_attention(q, k, v, group, *, sm_scale: float = 1.0,
                                q_segment_ids: Optional[torch.Tensor] = None,
                                kv_segment_ids: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Load-balanced causal ring attention (the zigzag schedule). The
    (B, H, L/S, D) shards must be in the zigzag layout (``zigzag_permute``
    the global sequence first): rank ``i``'s shard holds global chunks
    ``i`` and ``2S-1-i``, each L/(2S) long. Rotate q and k with each
    chunk's global offset before calling. Differentiable."""
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    lq = q.shape[2]
    if lq != k.shape[2] or lq % 2:
        raise ValueError(f"the zigzag ring needs q and kv shards of one even "
                         f"length; got {lq} and {k.shape[2]}")
    return _Zigzag.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                         q_segment_ids, kv_segment_ids, group, float(sm_scale))

