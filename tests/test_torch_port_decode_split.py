"""The decode kernel's split-S arithmetic against the JAX package.

``decode_attention_split_plain`` computes what ``csrc/decode_attention.cu``
computes, chunk by chunk: each chunk's (m, l, acc) and their merge in chunk
order. It must give the function of JAX's ``decode_attention_reference``
and of the Pallas ``decode_attention`` (interpret mode), at kv_len 0, 1,
C - 1, C, C + 1 and S with S = 2C + 3, in fp32, on a bf16 cache and on int8
codes with scales. The query is fp32 in every case, so nothing rounds at
the output and the fp32 bar of 1e-4 holds (tests/test_torch_parity.py:48).
The Pallas kernel needs S % 8 == 0: its cache is the same cache with five
zero positions appended, which no kv_len reaches.

The arithmetic is checked at the kernel's chunk (``CHUNK``, 256 positions)
and at 128, the chunk of the build that kosmosx_torch/studies/decode_study.py
compares it with.

``work_units`` mirrors the kernel's numbering of its (b, h, chunk) units on
the host: every unit below kv_len, and one empty unit per row of kv_len 0,
taken by exactly one block.
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kosmosx_torch.ops import decode_attention as tdec
from kosmosx_torch.studies import decode_study

# the module (kosmosx_tpu.ops re-exports a function of the same name)
jdec = importlib.import_module("kosmosx_tpu.ops.decode_attention")

TOL = dict(atol=1e-4, rtol=1e-4)
H, D = 2, 64
CHUNKS = (tdec.CHUNK, 128)


def _quantize(x):
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8), scale


def _inputs(kind, chunk, seed=0):
    """q (fp32), k, v and scales as numpy arrays; one batch row per kv_len
    of interest."""
    s_len = 2 * chunk + 3
    kv_len = np.array([0, 1, chunk - 1, chunk, chunk + 1, s_len], np.int32)
    rng = np.random.default_rng(seed)
    b = len(kv_len)
    q = (rng.standard_normal((b, H, 1, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((b, H, s_len, D)).astype(np.float32)
    v = rng.standard_normal((b, H, s_len, D)).astype(np.float32)
    scales = {}
    if kind == "int8":
        (k, ks), (v, vs) = _quantize(k), _quantize(v)
        scales = dict(k_scale=ks, v_scale=vs)
    return q, k, v, kv_len, scales


def _jax_cache(a, kind):
    return jnp.asarray(a, jnp.bfloat16) if kind == "bf16" else jnp.asarray(a)


def _torch_cache(a, kind):
    t = torch.from_numpy(a)
    return t.bfloat16() if kind == "bf16" else t


def _pad8(a):
    """The cache with zero positions appended up to a multiple of 8."""
    extra = -a.shape[2] % 8
    return np.concatenate([a, np.zeros(a.shape[:2] + (extra,) + a.shape[3:],
                                       a.dtype)], axis=2)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_split_plain_matches_jax(kind, chunk):
    q, k, v, kv_len, scales = _inputs(kind, chunk)
    out = tdec.decode_attention_split_plain(
        torch.from_numpy(q), _torch_cache(k, kind), _torch_cache(v, kind),
        torch.from_numpy(kv_len), chunk=chunk,
        **{n: torch.from_numpy(a) for n, a in scales.items()})
    jscales = {n: jnp.asarray(a) for n, a in scales.items()}
    jpad = {n: jnp.asarray(_pad8(a)) for n, a in scales.items()}
    with jax.default_matmul_precision("highest"):
        ref = jdec.decode_attention_reference(
            jnp.asarray(q), _jax_cache(k, kind), _jax_cache(v, kind),
            jnp.asarray(kv_len), **jscales)
        pallas = jdec.decode_attention(
            jnp.asarray(q), _jax_cache(_pad8(k), kind),
            _jax_cache(_pad8(v), kind), jnp.asarray(kv_len), block_s=64,
            interpret=True, **jpad)
    assert out.dtype == torch.float32 and out.shape == (len(kv_len), H, 1, D)
    # kv_len 0: the Pallas kernel (and the port) give 0, the reference's
    # softmax over a fully masked row the mean of v
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas, np.float32),
                               **TOL)
    np.testing.assert_allclose(out[1:].numpy(),
                               np.asarray(ref, np.float32)[1:], **TOL)
    assert torch.all(out[0] == 0)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_split_plain_matches_plain(kind):
    """The split arithmetic and the one-pass plain version agree on a longer
    cache whose kv_len cut chunks anywhere."""
    rng = np.random.default_rng(3)
    s_len = 1000
    q = torch.from_numpy(rng.standard_normal((3, H, 1, D)).astype(np.float32))
    k = rng.standard_normal((3, H, s_len, D)).astype(np.float32)
    v = rng.standard_normal((3, H, s_len, D)).astype(np.float32)
    kw = {}
    if kind == "int8":
        (k, ks), (v, vs) = _quantize(k), _quantize(v)
        kw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    kv_len = torch.tensor([1000, 517, 2000])   # the last clamps to S
    got = tdec.decode_attention_split_plain(q, k, v, kv_len, chunk=tdec.CHUNK,
                                            **kw)
    want = tdec.decode_attention_plain(q, k, v, kv_len.clamp(max=s_len), **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _expected_units(kv_len, heads, s_len, chunk):
    out = set()
    for b, n in enumerate(kv_len):
        n = min(max(int(n), 0), s_len)
        for h in range(heads):
            for c in range(max(1, -(-n // chunk))):
                out.add((b, h, c))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_work_units_cover_every_chunk_once(seed):
    """For random lengths (0 and past S among them), heads and grid sizes,
    the blocks' units are every (b, h, chunk) below kv_len and one empty
    unit per row of length 0, each taken once, each block's in increasing
    order with the chunks of one (b, h) numbered side by side."""
    rng = np.random.default_rng(seed)
    chunk = CHUNKS[seed % 2]
    s_len = int(rng.integers(1, 3000))
    b = int(rng.integers(1, 9))
    heads = int(rng.integers(1, 33))
    kv_len = rng.integers(-5, s_len + 50, size=b)
    kv_len[rng.integers(0, b)] = 0
    max_units = b * heads * -(-s_len // chunk)
    for grid in {1, 7, 132 * 3, max_units}:
        grid = min(grid, max_units)
        seen = []
        for block in range(grid):
            units = tdec.work_units(kv_len, heads, s_len, chunk, grid, block)
            order = [(u[0] * heads + u[1], u[2]) for u in units]
            assert order == sorted(order)
            seen += units
        assert len(seen) == len(set(seen))
        assert set(seen) == _expected_units(kv_len, heads, s_len, chunk)


@pytest.mark.parametrize("name,value", [
    ("KX_DECODE_CHUNK", tdec.CHUNK), ("KX_DECODE_STAGES", 1)])
def test_host_constants_match_the_kernel_source(name, value):
    """The wrapper sizes the partials by ``CHUNK``: the kernel source's
    default chunk must be the same, and its default build one buffer a
    block; its partial is ``_PART`` floats, (m, l, 2 unused, acc[64])."""
    src = (Path(tdec.__file__).resolve().parent.parent / "csrc"
           / "decode_attention.cu").read_text()
    assert re.search(rf"#define {name} (\d+)", src).group(1) == str(value)
    assert "constexpr int PART = 4 + D;" in src and tdec._PART == 4 + D


def test_work_units_number_rows_then_heads_then_chunks():
    """Block i of a grid of G takes units i, i + G, ... of the order (b, h,
    chunk): with one block the whole order."""
    units = tdec.work_units([300, 0, 129], 2, 300, 128, 1, 0)
    assert units == [(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 0), (0, 1, 1),
                     (0, 1, 2), (1, 0, 0), (1, 1, 0), (2, 0, 0), (2, 0, 1),
                     (2, 1, 0), (2, 1, 1)]
    assert tdec.work_units([300, 0, 129], 2, 300, 128, 5, 3) == [
        (0, 1, 0), (2, 0, 0)]


def test_decode_study_needs_a_card(capsys):
    """Without a CUDA device the decode study exits non-zero and prints no
    result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert decode_study.main() != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", sorted(decode_study.VARIANTS))
def test_decode_study_defines_reach_the_source(name):
    """Every copy the study builds sets a macro the kernel source reads,
    with a chunk the kernel takes (a multiple of 32 threads, 128 or 256)."""
    src = (Path(tdec.__file__).resolve().parent.parent / "csrc"
           / "decode_attention.cu").read_text()
    defines, chunk = decode_study.VARIANTS[name]
    for define in defines:
        macro = define[2:].split("=")[0]
        assert f"#ifndef {macro}" in src and f"= {macro};" in src
    assert chunk in CHUNKS
