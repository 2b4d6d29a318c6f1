"""The yardstick's arithmetic for the LFM2 configuration: the model FLOPs
of a forward, and the work of the entries the LFM2 forward adds (the short
conv, RMSNorm, the QK-norm/RoPE pass, the flash forward over grouped
key/value heads, the experts' grouped products), as ``perfbench/
roofline.py`` counts it: operations over the bf16 tensor-core peak, bytes
(each input read once, each output written once) over the HBM rate, the
larger of the two the bound. Plain functions of shapes, kept here so that
the yardstick does not move when the program does.
"""

from __future__ import annotations

from perfbench.roofline import Work, attention_pairs

HEAD_DIM = 64


def forward_flops(cfg: dict, batch: int, length: int) -> int:
    """Model FLOPs of one forward over ``batch`` rows of ``length``
    positions, each row one causal sequence: every projection (2 a
    multiply-add), causal attention pairs as given, each token on its
    ``num_experts_per_tok`` experts, the router, the head at every
    position; the conv's taps and the norms are counted too, small as they
    are."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    f, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    taps = cfg["conv_L_cache"]
    t = batch * length
    pairs = batch * attention_pairs(length, length, True)
    total = 2 * t * d * v
    for i, kind in enumerate(cfg["layer_types"]):
        if kind == "conv":
            total += t * (2 * d * 3 * d + 2 * taps * d + 2 * d * d)
        else:
            total += t * 2 * d * (h + 2 * hkv) * HEAD_DIM
            total += 4 * pairs * h * HEAD_DIM + t * 2 * h * HEAD_DIM * d
        if i < cfg["num_dense_layers"]:
            total += t * 6 * d * f
        else:
            total += t * (2 * d * e + k * 6 * d * fe)
    return total


def short_conv_work(rows: int, width: int, taps: int, itemsize: int) -> Work:
    """``op.short_conv``: (rows, 3 width) and the (width, taps) taps read,
    (rows, width) written; B * x~, the taps' sum and the gate a value."""
    ops = rows * width * (1 + 2 * taps + 1)
    nbytes = (4 * rows * width + width * taps) * itemsize
    return ops, nbytes


def rms_norm_work(rows: int, width: int, itemsize: int,
                  out_itemsize: int = None) -> Work:
    """``op.rms_norm``: x read (``itemsize``), y written (``out_itemsize``,
    x's by default), the scale read."""
    out = itemsize if out_itemsize is None else out_itemsize
    return 4 * rows * width, rows * width * (itemsize + out) + width * out


def qk_norm_rope_work(rows: int, heads: int, kv_heads: int, length: int,
                      itemsize: int) -> Work:
    """``op.qk_norm_rope``: the (rows, (H + 2 Hkv) 64) projection read, q,
    k and v written, the fp32 (L, 32) cos and sin tables read; the norm and
    the rotation about 10 operations a q or k value."""
    values = rows * (heads + 2 * kv_heads) * HEAD_DIM
    ops = 10 * rows * (heads + kv_heads) * HEAD_DIM
    return ops, 2 * values * itemsize + 2 * length * 32 * 4


def flash_fwd_gqa_work(b: int, h: int, kv_heads: int, lq: int, lk: int,
                       d: int, *, causal: bool, itemsize: int = 2) -> Work:
    """``flash_attention_fwd`` with ``kv_heads`` key/value heads: Q K^T and
    P V over the visible pairs of every query head; q read and o written at
    H heads, k and v read at Hkv, the fp32 l and m written."""
    pairs = attention_pairs(lq, lk, causal)
    nbytes = (2 * b * h * lq + 2 * b * kv_heads * lk) * d * itemsize \
        + 2 * b * h * lq * 4
    return 4 * b * h * pairs * d, nbytes


def moe_experts_work(assignments: int, experts: int, d: int, ffn: int,
                     itemsize: int) -> Work:
    """``op.moe_experts``: each of the ``assignments`` rows through its
    expert's w1 and w3 (D to F each) and w2 (F to D); the permuted rows
    and every expert's three matrices read, the outputs written."""
    ops = 6 * assignments * d * ffn
    nbytes = (2 * assignments * d + experts * 3 * d * ffn) * itemsize
    return ops, nbytes
