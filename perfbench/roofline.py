"""The yardstick's arithmetic: the chip's peaks, the least time a kernel
entry's work could take, and the model FLOPs of a step.

A bound is the larger of two times: the operations the entry's arguments
need over the bf16 tensor-core peak, and the bytes they need moved (each
input read once, each output written once) over the HBM rate. Causal pairs
are counted as given. The functions are plain functions of shapes
(the arithmetic of the program's ``ops/roofline.py``, kept here so that the
yardstick does not move when the program does).

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit.
"""

from __future__ import annotations

from typing import Iterable, Tuple

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12

Work = Tuple[int, int]  # (operations, bytes)


def bound_s(work: Work) -> float:
    """The least seconds the work could take on one H100."""
    flops, nbytes = work
    return max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_PER_S)


def attention_pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs one head scores; under causal masking, aligned at
    the top left, row r sees keys 0..r."""
    if not causal:
        return lq * lk
    n = min(lq, lk)
    return n * (n + 1) // 2 + (lq - n) * lk


def flash_fwd_work(b: int, h: int, lq: int, lk: int, d: int, *, causal: bool,
                   itemsize: int = 2) -> Work:
    """``flash_attention_fwd``: Q K^T and P V over the visible pairs; q, k,
    v read, o and the fp32 statistics l and m written."""
    pairs = attention_pairs(lq, lk, causal)
    nbytes = b * h * d * itemsize * (2 * lq + 2 * lk) + 2 * b * h * lq * 4
    return 4 * b * h * pairs * d, nbytes


def flash_bwd_work(b: int, h: int, lq: int, lk: int, d: int, *, causal: bool,
                   itemsize: int = 2) -> Work:
    """``flash_attention_bwd``: S = Q K^T again, dP = dO V^T, dV = P^T dO,
    dK = dS^T Q and dQ = dS K over the visible pairs; q, k, v, o, do and
    the fp32 l and m read, dq, dk and dv written."""
    pairs = attention_pairs(lq, lk, causal)
    nbytes = b * h * d * itemsize * (4 * lq + 4 * lk) + 2 * b * h * lq * 4
    return 10 * b * h * pairs * d, nbytes


def decode_work(kv_len: Iterable[int], h: int, d: int, *, q_itemsize: int = 2,
                kv_itemsize: int = 2, scales: bool = False) -> Work:
    """``decode_attention``: one query per (b, h) over its first
    ``kv_len[b]`` cache positions: those k and v rows (and their fp32
    scales) read, q read, o written."""
    kv_len = list(kv_len)
    positions = sum(kv_len)
    nbytes = 2 * positions * h * d * kv_itemsize
    nbytes += 2 * len(kv_len) * h * d * q_itemsize + 4 * len(kv_len)
    if scales:
        nbytes += 2 * positions * h * 4
    return 4 * positions * h * d, nbytes


def w8_matmul_work(m: int, k: int, n: int, *, x_itemsize: int = 2) -> Work:
    """``w8_matmul``/``w8_matmul_stacked``: x (m, k), one layer's (k, n)
    int8 codes and (n,) fp32 scales read, (m, n) written in x's type."""
    return 2 * m * k * n, (m * k + m * n) * x_itemsize + k * n + 4 * n


# ---------------------------------------------------------------------------
# model FLOPs: the published model's work on the given inputs, one multiway
# expert a position, causal pairs as given, no recomputation
# ---------------------------------------------------------------------------


def decoder_flops(cfg: dict, positions: int, pairs: int, *,
                  head_positions: int = None) -> int:
    """Forward FLOPs of the decoder over ``positions`` positions whose
    attention scores ``pairs`` (query, key) pairs a head, and the head over
    ``head_positions`` of them (default all)."""
    d = cfg["decoder"]
    e, f, n = d["embed_dim"], d["ffn_dim"], d["layers"]
    head = positions if head_positions is None else head_positions
    return (positions * 2 * n * (4 * e * e + 2 * e * f)
            + pairs * 4 * e * n + head * 2 * e * d["vocab_size"])


def vision_flops(cfg: dict) -> int:
    """Forward FLOPs of the vision tower on one image."""
    v = cfg["vision"]
    vd, m = v["hidden_dim"], v["mlp_dim"]
    patches = (v["image_size"] // v["patch_size"]) ** 2
    tokens = patches + 1
    per_layer = tokens * 2 * (4 * vd * vd + 2 * vd * m) + 4 * vd * tokens ** 2
    return patches * 2 * 3 * v["patch_size"] ** 2 * vd + v["layers"] * per_layer


def resampler_flops(cfg: dict) -> int:
    """Forward FLOPs of the resampler and the projection on one image."""
    r = cfg["resampler"]
    rd, inner, lat = r["dim"], r["dim_head"] * r["heads"], r["num_latents"]
    kv = r["num_media_embeds"] + lat
    per_layer = (2 * lat * rd * inner + 2 * kv * rd * 2 * inner
                 + 4 * inner * lat * kv + 2 * lat * inner * rd
                 + 2 * 2 * lat * rd * r["ff_mult"] * rd)
    return r["depth"] * per_layer + 2 * lat * rd * cfg["decoder"]["embed_dim"]


def sequence_flops(cfg: dict, length: int, images: int, *,
                   train: bool = False, head_positions: int = None) -> int:
    """One causal sequence of ``length`` decoder positions carrying
    ``images`` images: the forward, or with ``train`` the forward and
    backward of the trainable parts (3x) and the forward of the frozen
    vision tower."""
    dec = decoder_flops(cfg, length, length * (length + 1) // 2,
                        head_positions=head_positions)
    mult = 3 if train else 1
    return mult * (dec + images * resampler_flops(cfg)) \
        + images * vision_flops(cfg)


def decode_token_flops(cfg: dict, context: int) -> int:
    """One decode step of one sequence whose new token sees ``context``
    cached positions and itself."""
    return decoder_flops(cfg, 1, context + 1)


def entry_share(readings, labels, work) -> float:
    """A kernel entry's share of its roofline, in percent: the least time
    the work of its calls' arguments (``work(call)``) could take, over the
    device time of everything launched inside its spans. None where the
    profiled steps made no such call."""
    if readings is None or readings.profile is None:
        return None
    calls = [c for c in readings.calls if c.label in labels]
    device_s = sum(readings.profile.span_device_s.get(lab, 0.0)
                   for lab in labels)
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(bound_s(work(c)) for c in calls) / device_s
