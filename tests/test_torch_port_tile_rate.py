"""The tile-rate study's kernel path of kosmosx_torch against the JAX study.

``benchmarks.tile_rate_study.make_fn(d, 2)`` runs its Pallas kernel in TPU
interpret mode on the CPU, at the study's L = 1024; the port's wrapper takes
its plain version for CPU tensors. The same bf16 inputs, made from a numpy
seed, go through both. Bar: 1e-2 of the reference's largest value: the
output rounds to bf16, and S rounds to bf16 between the products, where a
different fp32 summation order can flip a rounding. Also here: the
wrapper's input checks, the work counts and bounds of ``ops/roofline.py``
against hand-computed values, and the study's refusal to run without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from benchmarks import tile_rate_study as jstudy
from kosmosx_torch.ops import roofline
from kosmosx_torch.ops import tile_rate as ttr
from kosmosx_torch.studies import tile_rate_study as tstudy

G = 2


def _inputs(d, g=G, length=jstudy.L, seed=0):
    """bf16 (g, length, d) q, k, v as torch tensors and as the float32 numpy
    arrays of the same values."""
    rng = np.random.default_rng(seed + d)
    ts = [torch.from_numpy(rng.standard_normal((g, length, d),
                                               dtype=np.float32)).bfloat16()
          for _ in range(3)]
    return ts, [t.float().numpy() for t in ts]


def _rel_err(a, ref):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("d", ttr.HEAD_DIMS)
def test_tile_kernel_path_matches_pallas_kernel(d):
    (q, k, v), arrays = _inputs(d)
    with pltpu.force_tpu_interpret_mode():
        ref = jstudy.make_fn(d, G)(*(jnp.asarray(a, jnp.bfloat16)
                                     for a in arrays))
    ref = np.asarray(ref.astype(jnp.float32))
    before = ttr.tile_attention_skeleton.launches
    out = ttr.tile_attention_skeleton(q, k, v)
    assert ttr.tile_attention_skeleton.launches == before  # plain on the CPU
    assert out.dtype == torch.bfloat16 and out.shape == (G, jstudy.L, d)
    assert _rel_err(out.float().numpy(), ref) < 1e-2
    assert _rel_err(ttr.tile_attention_skeleton_plain(q, k, v).float().numpy(),
                    ref) < 1e-2


def _bad_inputs(kind):
    (q, k, v), _ = _inputs(64, length=128)
    if kind == "fp32":
        return q.float(), k.float(), v.float()
    if kind == "head_dim_96":
        (q, k, v), _ = _inputs(96, length=128)
    elif kind == "ragged_L":
        q, k, v = (t[:, :100].contiguous() for t in (q, k, v))
    elif kind == "non_contiguous":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif kind == "shapes_differ":
        k = k[:, :64].contiguous()
    return q, k, v


@pytest.mark.parametrize("kind,error", [
    ("fp32", TypeError), ("head_dim_96", ValueError), ("ragged_L", ValueError),
    ("non_contiguous", ValueError), ("shapes_differ", ValueError)])
def test_tile_wrapper_raises_on_what_the_kernel_does_not_take(kind, error):
    with pytest.raises(error):
        ttr.tile_attention_skeleton(*_bad_inputs(kind))


@pytest.mark.parametrize("d,g,flops,nbytes", [
    (64, 256, 68_719_476_736, 134_217_728),
    (128, 128, 68_719_476_736, 134_217_728),
    (128, 256, 137_438_953_472, 268_435_456)])
def test_tile_rate_work_counts(d, g, flops, nbytes):
    """4 g L^2 d flops and 8 g L d bytes at the study's L = 1024."""
    assert ttr.tile_rate_flops(d, g, 1024) == flops
    assert ttr.tile_rate_bytes(d, g, 1024) == nbytes


FLASH = (2, 32, 2048, 2048, 64)
DECODE_KV_LEN = (2048, 1999, 1500, 1024, 777, 512, 100, 1)  # chip_smoke's
# (work, least time in microseconds, what sets it), from the shapes by hand
BOUNDS = {
    "flash_fwd": (roofline.flash_fwd_work(*FLASH, causal=True, xpos=True),
                  34.76, "operations"),
    "flash_bwd_dkv": (roofline.flash_bwd_dkv_work(*FLASH, causal=True,
                                                  xpos=True),
                      69.52, "operations"),
    "flash_bwd_dq": (roofline.flash_bwd_dq_work(*FLASH, causal=True,
                                                xpos=True),
                     52.14, "operations"),
    "decode_bf16": (roofline.decode_work(DECODE_KV_LEN, 32, 64), 19.49,
                    "bytes"),
    "decode_int8": (roofline.decode_work(DECODE_KV_LEN, 32, 64, kv_itemsize=1,
                                         scales=True), 10.36, "bytes"),
    "w8_decode": (roofline.w8_matmul_work(4, 2048, 8192), 5.04, "bytes"),
    "w8_vocab_head": (roofline.w8_matmul_work(4, 2048, 32002), 19.68, "bytes"),
    "w8_prefill": (roofline.w8_matmul_work(3968, 2048, 8192), 134.62,
                   "operations"),
    "tile_d64_g256": (roofline.tile_rate_work(64, 256, 1024), 69.48,
                      "operations"),
    "tile_d128_g256": (roofline.tile_rate_work(128, 256, 1024), 138.97,
                       "operations"),
}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_kernel_bounds(name):
    """Bounds of the main path's shapes: flash at (2, 32, 2048, 64) causal
    with fused xPos (2048 * 2049 / 2 pairs per head), decode over the 7961
    cache positions of kv_len, W8 over one layer's codes."""
    work, want_us, want_by = BOUNDS[name]
    ms, by = roofline.bound(work)
    assert by == want_by
    assert ms * 1e3 == pytest.approx(want_us, rel=1e-3)


@pytest.mark.parametrize("xpos,flops,nbytes,want_us", [
    # o, do, q, k read (4 x 16.8 MB), q', k' written, di (0.5 MB), the four
    # 2048 x 64 fp32 tables (2.1 MB)
    (True, 67_108_864, 103_284_736, 30.83),
    # o and do read, di written; q and k pass through
    (False, 16_777_216, 34_078_720, 10.17)])
def test_flash_bwd_prep_bound(xpos, flops, nbytes, want_us):
    """The pre-pass at (2, 32, 2048, 64) bf16: bound by its bytes, its CUDA-
    core operations (2 per element of o, 3 per rotated element) far under
    them at the fp32 peak."""
    work = roofline.flash_bwd_prep_work(*FLASH, xpos=xpos)
    assert work == (flops, nbytes)
    ms, by = roofline.bound(work, roofline.H100_FP32_FLOPS)
    assert by == "bytes"
    assert ms * 1e3 == pytest.approx(want_us, rel=1e-3)


@pytest.mark.parametrize("work,nbytes", [
    # q', dO (2048 rows) and k', v, dk, dv (2048 rows) at 8192 bytes a row
    # over all heads, l, m, di (1.5 MB), the k tables (1 MB)
    (roofline.flash_bwd_dkv_work(*FLASH, causal=True, xpos=True),
     103_284_736),
    # q', dO, dq and k', v; the q tables
    (roofline.flash_bwd_dq_work(*FLASH, causal=True, xpos=True), 86_507_520)],
    ids=["dkv", "dq"])
def test_flash_bwd_bytes(work, nbytes):
    """The backward kernels read the pre-pass's q' and k' and only the
    tables of the side they map back."""
    assert work[1] == nbytes


def test_attention_pairs():
    assert roofline.attention_pairs(4, 4, causal=True) == 10
    assert roofline.attention_pairs(4, 2, causal=True) == 7
    assert roofline.attention_pairs(3, 5, causal=False) == 15


def test_study_needs_a_card(capsys):
    """Without a CUDA device the study exits non-zero and prints no
    result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert tstudy.main() != 0
    assert capsys.readouterr().out == ""


def test_study_verdict_rule():
    """The JAX study's rule: d64 / d128 FLOP-matched time ratio above 1.6."""
    assert tstudy.verdict(1.7).startswith("shape floor REAL")
    assert tstudy.verdict(1.6).startswith("no/partial")
