"""The yardstick's arithmetic against hand counts."""

import pytest

from perfbench import roofline
from perfbench.tests.perfbench_tiny import ROOT


def test_pairs():
    assert roofline.attention_pairs(4, 4, True) == 10
    assert roofline.attention_pairs(3, 5, False) == 15
    assert roofline.attention_pairs(2046, 2046, True) == 2046 * 2047 // 2


def test_flash_work():
    # one head, 4 positions, d 2: 10 pairs; QK^T and PV 2 flops a product
    assert roofline.flash_fwd_work(1, 1, 4, 4, 2, causal=True) == (
        4 * 10 * 2, 2 * 2 * (4 + 4 + 4 + 4) + 2 * 4 * 4)
    # five products in the backward; q k v o do read, dq dk dv written
    assert roofline.flash_bwd_work(1, 1, 4, 4, 2, causal=True) == (
        10 * 10 * 2, 2 * 2 * 8 * 4 + 2 * 4 * 4)


def test_decode_and_w8_work():
    flops, nbytes = roofline.decode_work([3, 5], 2, 4)
    assert flops == 4 * 8 * 2 * 4
    assert nbytes == 2 * 8 * 2 * 4 * 2 + 2 * 2 * 2 * 4 * 2 + 4 * 2
    assert roofline.w8_matmul_work(4, 2048, 8192) == (
        2 * 4 * 2048 * 8192, (4 * 2048 + 4 * 8192) * 2 + 2048 * 8192
        + 4 * 8192)


def test_bound():
    assert roofline.bound_s((989e12, 0)) == pytest.approx(1.0)
    assert roofline.bound_s((0, 3.35e12)) == pytest.approx(1.0)


def test_model_flops_by_hand():
    import json

    cfg = json.loads((ROOT / "perfbench/configs/kosmosx.json").read_text())
    e, f, v, n = 2048, 8192, 32002, 24
    per_pos = 2 * n * (4 * e * e + 2 * e * f) + 2 * e * v
    length = 2046
    pairs = length * (length + 1) // 2
    dec = length * per_pos + pairs * 4 * e * n
    vd, m, tok = 1024, 4096, 257
    vit = 256 * 2 * 588 * vd + 24 * (tok * 2 * (4 * vd * vd + 2 * vd * m)
                                     + 4 * vd * tok * tok)
    lat, kv = 64, 321
    res = 2 * (2 * lat * 1024 * 512 + 2 * kv * 1024 * 1024
               + 4 * 512 * lat * kv + 2 * lat * 512 * 1024
               + 2 * 2 * lat * 1024 * 4096) + 2 * lat * 1024 * e
    assert roofline.vision_flops(cfg) == vit
    assert roofline.resampler_flops(cfg) == res
    assert roofline.sequence_flops(cfg, length, 1) == dec + res + vit
    assert roofline.sequence_flops(cfg, length, 1, train=True) == \
        3 * (dec + res) + vit
    # about 68 TFLOP a training step of 4 such rows
    assert 66e12 < 4 * roofline.sequence_flops(cfg, length, 1, train=True) \
        < 70e12
    assert roofline.decode_token_flops(cfg, 99) == per_pos + 100 * 4 * e * n
