"""The least time one NVIDIA H100 could take for each kernel's work.

A kernel's bound is the larger of two times: the operations its function
needs over the tensor cores' bf16 peak, and the bytes it must move (each
input read once, each output written once) over the HBM rate. Where the
work depends on the data (causal masking, a ragged ``kv_len``), the counts
are those of the given inputs, not the most they could be. Every function
here is a plain function of shapes; ``chip_smoke.py`` puts the bound beside
each kernel's measured time.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from kosmosx_torch.ops.tile_rate import tile_rate_bytes, tile_rate_flops

H100_BF16_FLOPS = 989e12  # tensor cores, dense
H100_HBM_BYTES_PER_S = 3.35e12

Work = Tuple[int, int]  # (operations, bytes)


def bound(work: Work) -> Tuple[float, str]:
    """(least time in ms, "operations" or "bytes": which of the two sets
    it)."""
    flops, nbytes = work
    t_ops = flops / H100_BF16_FLOPS
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by


def attention_pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs one head scores: under causal masking, aligned at
    the top left, row r sees keys 0..r."""
    if not causal:
        return lq * lk
    return sum(min(r + 1, lk) for r in range(lq))


def _attention_bytes(b, h, lq, lk, d, itemsize, *, q_tensors, k_tensors,
                     stats, xpos):
    """``q_tensors`` (B, H, Lq, d) and ``k_tensors`` (B, H, Lk, d) tensors in
    the input type, ``stats`` fp32 (B, H, Lq) rows, and the four (L, d) fp32
    xPos tables when xPos is fused."""
    nbytes = b * h * d * itemsize * (q_tensors * lq + k_tensors * lk)
    nbytes += b * h * lq * 4 * stats
    if xpos:
        nbytes += 2 * (lq + lk) * d * 4
    return nbytes


def flash_fwd_work(b: int, h: int, lq: int, lk: int, d: int, *, causal: bool,
                   itemsize: int = 2, xpos: bool = False) -> Work:
    """Q K^T and P V over the visible pairs; q, k, v read, o, l, m
    written."""
    pairs = attention_pairs(lq, lk, causal)
    return (4 * b * h * pairs * d,
            _attention_bytes(b, h, lq, lk, d, itemsize, q_tensors=2,
                             k_tensors=2, stats=2, xpos=xpos))


def flash_bwd_dkv_work(b: int, h: int, lq: int, lk: int, d: int, *,
                       causal: bool, itemsize: int = 2,
                       xpos: bool = False) -> Work:
    """S = Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q over the visible
    pairs; q, k, v, do, l, m, di read, dk, dv written."""
    pairs = attention_pairs(lq, lk, causal)
    return (8 * b * h * pairs * d,
            _attention_bytes(b, h, lq, lk, d, itemsize, q_tensors=2,
                             k_tensors=4, stats=3, xpos=xpos))


def flash_bwd_dq_work(b: int, h: int, lq: int, lk: int, d: int, *,
                      causal: bool, itemsize: int = 2,
                      xpos: bool = False) -> Work:
    """S = Q K^T, dP = dO V^T, dQ = dS K over the visible pairs; q, k, v,
    do, l, m, di read, dq written."""
    pairs = attention_pairs(lq, lk, causal)
    return (6 * b * h * pairs * d,
            _attention_bytes(b, h, lq, lk, d, itemsize, q_tensors=3,
                             k_tensors=2, stats=3, xpos=xpos))


def decode_work(kv_len: Iterable[int], h: int, d: int, *, q_itemsize: int = 2,
                kv_itemsize: int = 2, scales: bool = False) -> Work:
    """One query per (b, h) over its first ``kv_len[b]`` cache positions:
    those k and v rows (and their fp32 scales) read, q read, o written."""
    kv_len = list(kv_len)
    positions = sum(kv_len)
    nbytes = 2 * positions * h * d * kv_itemsize   # k and v rows
    nbytes += 2 * len(kv_len) * h * d * q_itemsize  # q and o
    nbytes += 4 * len(kv_len)                       # kv_len
    if scales:
        nbytes += 2 * positions * h * 4
    return 4 * positions * h * d, nbytes


def w8_matmul_work(m: int, k: int, n: int, *, x_itemsize: int = 2) -> Work:
    """(x @ q) * scale: x (m, k) and the (k, n) int8 codes and (n,) fp32
    scales of one layer read, (m, n) written in x's type."""
    return 2 * m * k * n, (m * k + m * n) * x_itemsize + k * n + 4 * n


def tile_rate_work(d: int, g: int, length: int) -> Work:
    """The tile-rate skeleton (ops/tile_rate.py)."""
    return tile_rate_flops(d, g, length), tile_rate_bytes(d, g, length)
