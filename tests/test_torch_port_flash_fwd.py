"""The flash forward's rotation pass, the forward as ``flash_attention_fwd``
composes it (rotation, then attention over q' and k'), and the test for a
tile that takes no mask, against the JAX package on the CPU.

The rotation's q' is held against ``_apply_rot`` with ``_xpos_tables`` times
``sm_scale * log2(e)`` (kosmosx_tpu/ops/flash_attention.py:122-147, 247-251)
and its k' against ``_apply_rot`` with the k tables, on numpy inputs from a
seed: 1e-6 in fp32 (the two packages build their tables by different
expressions, an ulp apart) and bit for bit in bf16. At these shapes no
table ulp flips a bf16 rounding; at (2, 3, 2048, 16) one flips 3 of
393,216 values by one bf16 step. The composed forward is held against the
Pallas forward in interpret mode at 1e-4 (fp32), with and without segment
ids. The kernels
themselves are held against these plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kosmosx_torch.ops import flash_attention as tfa
from kosmosx_torch.ops import roofline

jfa = importlib.import_module("kosmosx_tpu.ops.flash_attention")

B, H, D = 2, 3, 16
SM_SCALE = D ** -0.5
SHAPES = {"equal": (96, 96), "unequal": (80, 144)}  # (Lq, Lk)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(x, dtype):
    """numpy fp32 -> torch in ``dtype``, rounded as jnp rounds it."""
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


def _jax_rotated(q, k, jdt):
    """q' and k' as the Pallas forward computes them on its tiles: the
    tables of ``_xpos_tables``, c folded into the q side by ``_fwd``, and
    ``_apply_rot`` on each (L, D) head, in fp32 and in x's dtype."""
    lq, lk = q.shape[2], k.shape[2]
    c = SM_SCALE * jfa.LOG2E
    q_sin, q_cos, k_sin, k_cos = jfa._xpos_tables(lq, lk, D, 512, lq // 2)
    rot = jfa._rot_matrix(D)

    def rotate(x, sin, cos):
        per_head = jax.vmap(jax.vmap(lambda y: jfa._apply_rot(y, sin, cos, rot)))
        return np.asarray(per_head(jnp.asarray(x, jdt)).astype(jnp.float32))

    with jax.default_matmul_precision("highest"):
        return rotate(q, q_sin * c, q_cos * c), rotate(k, k_sin, k_cos)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fwd_prep_plain_matches_jax(shape, dtype):
    lq, lk = SHAPES[shape]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(lq + lk)
    q = rng.standard_normal((B, H, lq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, lk, D)).astype(np.float32)
    jq, jk = _jax_rotated(q, k, jdt)
    tq, tk = _to_torch(q, tdt), _to_torch(k, tdt)
    before = tfa.flash_fwd_prep.launches
    q_r, k_r = tfa.flash_fwd_prep(tq, tk, sm_scale=SM_SCALE, xpos_scale_base=512)
    assert tfa.flash_fwd_prep.launches == before  # the plain version
    assert q_r.dtype == tdt and k_r.dtype == tdt
    assert q_r.shape == tq.shape and k_r.shape == tk.shape
    for got, want in ((q_r, jq), (k_r, jk)):
        got = got.float().numpy()
        if tdt == torch.float32:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


def test_fwd_prep_is_the_rotation_of_the_plain_forward():
    """The plain forward's scores under xPos are q' k'^T of the rotation
    pass, bit for bit: the kernel and the plain version stream the same
    q' and k'."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, 64, D))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    kw = dict(sm_scale=SM_SCALE, xpos_scale_base=512, xpos_center=32)
    q_r, k_r = tfa.flash_fwd_prep_plain(q, k, **kw)
    s = q_r.float() @ k_r.float().transpose(-1, -2)
    _, _, m = tfa.flash_attention_plain(q, k, v, causal=False, **kw)
    assert torch.equal(m, s.amax(-1))


def test_fwd_prep_without_xpos_passes_through():
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 9, 64, dtype=torch.bfloat16)
    q_r, k_r = tfa.flash_fwd_prep(q, k)
    assert q_r is q and k_r is k
    meta = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_fwd_prep(meta, meta, xpos_scale_base=512)


def _ids(length, bounds):
    """Segment ids (B, length): row b counts up at each bound in
    ``bounds[b]`` (packed documents), -1 from the last one (padding)."""
    ids = np.zeros((len(bounds), length), np.int32)
    for r, row in enumerate(bounds):
        for j, at in enumerate(row[:-1]):
            ids[r, at:] = j + 1
        ids[r, row[-1]:] = -1
    return ids


# (Lq, Lk, causal, xPos, segment ids): ids uniform (the training batches),
# ids that change inside a tile, and Lq != Lk
COMPOSED = {
    "causal_xpos": (128, 128, True, True, None),
    "causal_xpos_uniform_ids": (128, 128, True, True, "uniform"),
    "causal_xpos_mixed_ids": (128, 128, True, True, [(40, 100), (128, 128)]),
    "causal_unequal": (192, 128, True, True, None),
    "non_causal_unequal_mixed_ids": (128, 192, False, False,
                                     [(70, 150), (192, 192)]),
}


@pytest.mark.parametrize("case", sorted(COMPOSED))
def test_composed_forward_matches_pallas(case):
    """rotation -> attention over q' and k', as the port's forward runs it,
    against the Pallas forward (interpret mode, blocks of 64), fp32: o, l
    and m at 1e-4."""
    lq, lk, causal, xpos, ids = COMPOSED[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((B, H, lq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, lk, D)).astype(np.float32)
            for _ in range(2))
    qs = ks = None
    if ids == "uniform":
        qs, ks = np.zeros((B, lq), np.int32), np.zeros((B, lk), np.int32)
    elif ids is not None:
        qs = _ids(lq, [(a, min(b_, lq)) for a, b_ in ids])
        ks = _ids(lk, ids)
    with jax.default_matmul_precision("highest"):
        jqs = jks = tables = None
        if qs is not None:
            jqs = jnp.broadcast_to(jnp.asarray(qs)[:, :, None], (B, lq, 8))
            jks = jnp.broadcast_to(jnp.asarray(ks)[:, None, :], (B, 8, lk))
        if xpos:
            tables = jfa._xpos_tables(lq, lk, D, 512, lq // 2)
        o_j, l_j, m_j = jfa._fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jqs, jks, tables,
            causal=causal, sm_scale=SM_SCALE, block_q=64, block_kv=64,
            mask_value=jfa.DEFAULT_MASK_VALUE, interpret=True)
    seg = (None, None) if qs is None else (torch.from_numpy(qs),
                                           torch.from_numpy(ks))
    o, l, m = tfa.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        sm_scale=SM_SCALE, q_segment_ids=seg[0], kv_segment_ids=seg[1],
        xpos_scale_base=512 if xpos else None)
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **tol)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j)[..., 0], **tol)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j)[..., 0], **tol)


# (Lq, Lk, causal, q ids, kv ids) for the whole-tile test
WHOLE = {
    "causal_no_ids": (200, 200, True, None),
    "causal_uniform_ids": (256, 256, True, "uniform"),
    "causal_packed": (256, 256, True, [(64, 200), (100, 256)]),
    "non_causal_unequal_padding": (100, 177, False, [(177,), (130,)]),
    "causal_short": (40, 23, True, "uniform"),
}


@pytest.mark.parametrize("case", sorted(WHOLE))
def test_whole_tiles_see_every_entry(case):
    """Every tile the kernels' test calls whole (16 q rows of a warp by 64
    kv columns, or 64 by 64 for the dK/dV warpgroup's q tiles) is all
    visible under ``_mask``; uniform ids leave the interior tiles whole,
    and a tile whose ids change is not whole."""
    lq, lk, causal, ids = WHOLE[case]
    qs = ks = None
    if ids == "uniform":
        qs, ks = torch.zeros(2, lq, dtype=torch.int32), \
            torch.zeros(2, lk, dtype=torch.int32)
    elif ids is not None:
        ks = torch.from_numpy(_ids(lk, [(*r[:-1], min(r[-1], lk)) for r in ids]))
        qs = ks[:, :lq] if lq <= lk else None
    mask = tfa._mask(2, lq, lk, causal, qs, ks, "cpu")
    for rows in (16, 64):
        whole = tfa.whole_tiles(2, lq, lk, causal, qs, ks, rows=rows)
        assert whole.shape == (2, -(-lq // rows), -(-lk // 64))
        full = torch.ones(2, lq, lk, dtype=torch.bool) if mask is None \
            else mask[:, 0].expand(2, lq, lk)
        for b, i, j in whole.nonzero().tolist():
            assert bool(full[b, i * rows:(i + 1) * rows, j * 64:(j + 1) * 64].all()), \
                (rows, b, i, j)
        if ids == "uniform" and lk >= 64 and lq >= 128:
            # the tiles below the diagonal and inside Lk are whole
            assert bool(whole[:, -1, 0].all())
        if case == "causal_packed":
            # ids change at 64 (row 0) and at 100 (row 1): kv tile 1 is
            # mixed in row 1, and in row 0 whole for the q rows from 128
            # (id 1, below the diagonal), not for those of the padding
            assert not bool(whole[1, :, 1].any())
            assert bool(whole[0, 128 // rows, 1])
            assert not bool(whole[0, -1, 1])


def test_whole_tiles_without_ids_follow_the_bounds():
    """Without segment ids a tile is whole where it lies inside Lk and at or
    below the diagonal of the warp's first row."""
    whole = tfa.whole_tiles(1, 130, 150, True)
    expect = torch.zeros(9, 3, dtype=torch.bool)
    for i in range(9):
        for j in range(3):
            expect[i, j] = j * 64 + 64 <= 150 and j * 64 + 63 <= i * 16
    assert torch.equal(whole[0], expect)


def test_fwd_prep_bound():
    """The rotation at (2, 32, 2048, 64) bf16: q and k read and q', k'
    written (4 x 16.8 MB) and the four 2048 x 64 fp32 tables (2.1 MB) over
    3.35 TB/s; its 3 operations per element far under them at the fp32
    peak."""
    work = roofline.flash_fwd_prep_work(2, 32, 2048, 2048, 64)
    assert work == (50_331_648, 69_206_016)
    ms, by = roofline.bound(work, roofline.H100_FP32_FLOPS)
    assert by == "bytes"
    assert ms * 1e3 == pytest.approx(20.66, rel=1e-3)
