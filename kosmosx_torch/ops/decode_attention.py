"""Single-query decode attention over a KV cache: the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version (counterpart of
kosmosx_tpu/ops/decode_attention.py).

Semantics of ``decode_attention`` and ``decode_attention_reference``
(kosmosx_tpu/ops/decode_attention.py:214-255, :59-74): q (B, H, 1, hd) is
already scaled and xPos-rotated by the caller; k/v (B, H, S, hd) is the cache,
in q's dtype or as int8 codes with ``k_scale``/``v_scale`` (B, H, S, 1) fp32;
only the positions ``j < kv_len[b]`` are attended. The k scales multiply the
scores and the v scales the probabilities. Output (B, H, 1, hd) in q's dtype.
A row with ``kv_len`` 0 returns 0, as the TPU kernel does.

The kernel splits each (b, h) row of the cache into chunks of ``CHUNK``
positions, reduces each chunk on its own and merges the chunks' partials
in chunk order in the same launch (split-S);
``decode_attention_split_plain`` computes those partials and that merge in
plain torch, for the tests.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kosmosx_torch.ops.flash_attention import HEAD_DIMS, MASK_VALUE
from kosmosx_torch.utils import trace

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
CHUNK = 256  # cache positions per work unit (KX_DECODE_CHUNK of the kernel)
_PART = 68  # floats of a unit's partial in the kernel's scratch: m, l, 2, acc


def decode_attention_plain(q, k, v, kv_len, *, k_scale=None, v_scale=None):
    """The kernel's function in plain torch, fp32 math."""
    s = q.float() @ k.float().transpose(-1, -2)          # (B, H, 1, S)
    if k_scale is not None:
        s = s * k_scale.float().transpose(-1, -2)
    valid = (torch.arange(k.shape[2], device=q.device)[None, None, None, :]
             < kv_len.to(q.device)[:, None, None, None])
    s = torch.where(valid, s, MASK_VALUE)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    if v_scale is not None:
        p = p * v_scale.float().transpose(-1, -2)
    return (p @ v.float()).to(q.dtype)


def decode_attention_split_plain(q, k, v, kv_len, *, chunk, k_scale=None,
                                v_scale=None):
    """The kernel's split-S arithmetic in plain torch, fp32: per chunk of
    ``chunk`` positions that starts below ``kv_len``, the log2-domain
    maximum m, the sum l of 2^(s - m) and acc = sum 2^(s - m) v (the v
    scales folding into the probabilities); then, in chunk order,
    o = sum acc_c 2^(m_c - M) / sum l_c 2^(m_c - M) with M the largest m_c.
    A row with ``kv_len`` 0 has no chunk and gives 0."""
    b, h, _, d = q.shape
    s_len = k.shape[2]
    lens = kv_len.to(q.device).clamp(0, s_len)
    s = (q.float() @ k.float().transpose(-1, -2)) * math.log2(math.e)
    if k_scale is not None:
        s = s * k_scale.float().transpose(-1, -2)
    vf = v.float() if v_scale is None else v.float() * v_scale.float()
    pos = torch.arange(s_len, device=q.device)
    parts = []
    for c0 in range(0, s_len, chunk):
        live = (c0 < lens)[:, None, None, None]          # chunk below kv_len
        valid = (pos[c0:c0 + chunk] < lens[:, None])[:, None, None, :]
        sc = torch.where(valid, s[..., c0:c0 + chunk], -math.inf)
        m = torch.where(live, sc.amax(dim=-1, keepdim=True), -math.inf)
        p = torch.where(valid, torch.exp2(sc - m), 0.0)
        parts.append((m, p.sum(dim=-1, keepdim=True), p @ vf[:, :, c0:c0 + chunk]))
    big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    num = torch.zeros(b, h, 1, d, device=q.device)
    den = torch.zeros(b, h, 1, 1, device=q.device)
    for m, l, acc in parts:
        e = torch.where(m > -math.inf, torch.exp2(m - big), 0.0)
        num = num + acc * e
        den = den + l * e
    return (num / torch.where(den == 0.0, 1.0, den)).to(q.dtype)


def work_units(kv_len, heads: int, s_len: int, chunk: int, grid: int,
               block: int) -> list:
    """The (b, h, chunk) work units block ``block`` of a ``grid``-block
    launch takes, in its order: a host mirror of the kernel's numbering
    (``Cursor`` in ``csrc/decode_attention.cu``), for the tests. Units are
    numbered row by row (b, then h, then chunk), a row of length L having
    max(1, ceil(L / chunk)) chunks (kv_len clamped to [0, S]; a row of
    length 0 one empty unit), and block i takes units i, i + grid, ..."""
    lens = [min(max(int(n), 0), s_len) for n in kv_len]
    out, base, b = [], 0, 0
    nc = max(1, -(-lens[0] // chunk))
    u = block
    while True:
        while u >= base + heads * nc:          # Cursor::seek
            base += heads * nc
            b += 1
            if b >= len(lens):
                return out
            nc = max(1, -(-lens[b] // chunk))
        h, c = divmod(u - base, nc)
        out.append((b, h, c))
        u += grid


def _check_cuda_inputs(q, k, v, kv_len, k_scale, v_scale):
    b, h, lq, hd = q.shape
    if q.dtype not in _Q_CODES:
        raise TypeError(f"decode kernel q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in (q.dtype, torch.int8):
        raise TypeError(f"decode kernel k/v must both be {q.dtype} or int8; "
                        f"got {k.dtype}/{v.dtype}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k.dtype == torch.int8 and k_scale is None:
        raise ValueError("int8 k/v codes need k_scale and v_scale")
    if k.shape != v.shape or k.ndim != 4 or k.shape[:2] != (b, h) \
            or k.shape[3] != hd:
        raise ValueError(f"k/v must be (B, H, S, hd) matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}/{tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode kernel head dim must be one of {HEAD_DIMS}, "
                         f"got {hd}")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be ({b},), got {tuple(kv_len.shape)}")
    tensors = [("q", q), ("k", k), ("v", v), ("kv_len", kv_len)]
    if k_scale is not None:
        s_shape = (b, h, k.shape[2], 1)
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != s_shape or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 {s_shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode kernel needs a contiguous, 16-byte "
                             f"aligned {name}")


def _decode_cuda(q, k, v, kv_len, k_scale, v_scale):
    from kosmosx_torch.ops import _build
    from kosmosx_torch.ops.quant_matmul import _tickets

    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    _check_cuda_inputs(q, k, v, kv_len, k_scale, v_scale)
    b, h, _, hd = q.shape
    s_len = k.shape[2]
    o = torch.empty_like(q)
    # the chunks' partials and a ticket per (b, h), for rows of several
    # chunks; the launch leaves the tickets 0
    chunks = -(-s_len // CHUNK)
    partial = (torch.empty(b * h * chunks * _PART, dtype=torch.float32,
                           device=q.device) if chunks > 1 else None)
    tickets = _tickets(q.device, b * h) if chunks > 1 else None
    lib = _build.library()
    err = lib.kx_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        o.data_ptr(), None if partial is None else partial.data_ptr(),
        None if tickets is None else tickets.data_ptr(), b, h, s_len, hd,
        _Q_CODES[q.dtype], _KV_CODES[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attention launch")
    decode_attention.launches += 1
    return o


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-query cached attention.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel of
    ``csrc/decode_attention.cu`` (built at first use) or raises."""
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(f"decode_attention is single-query (B, H, 1, hd); "
                         f"got {tuple(q.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode attention runs on cpu or cuda, not {q.device}")
    with trace.span("op.decode_attention", device=True) as sp:
        if sp.on:
            sp.set(b=q.shape[0], h=q.shape[1], d=q.shape[3], s=k.shape[2],
                   q_itemsize=q.element_size(), kv_itemsize=k.element_size(),
                   scales=k_scale is not None)
        if q.device.type == "cpu":
            return decode_attention_plain(q, k, v, kv_len, k_scale=k_scale,
                                          v_scale=v_scale)
        return _decode_cuda(q, k, v, kv_len, k_scale, v_scale)


# kernel launches on CUDA tensors (plain-version calls are not counted)
decode_attention.launches = 0
