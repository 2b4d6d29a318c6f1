"""The flash backward's pre-pass and the backward as ``flash_attention_bwd``
composes it (pre-pass, then the dK/dV and dQ plain versions), against the
JAX package on the CPU.

The pre-pass's q' and k' are held against ``_apply_rot`` with
``_xpos_tables`` (kosmosx_tpu/ops/flash_attention.py:122-147) and its ``di``
against the expression of ``_bwd`` (:476), on numpy inputs from a seed.
Bars: 1e-6 in fp32 (the two packages build their xPos tables by different
expressions, an ulp apart); one bf16 ulp of the value in bf16 (a table ulp
can flip a rounding). The composed backward is held against ``jax.grad``
through the Pallas kernels in interpret mode at 1e-4, the bar of
tests/test_torch_port_ops.py. The kernels themselves are held against these
plain versions on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kosmosx_torch.ops import flash_attention as tfa
from kosmosx_tpu.nn.xpos import apply_xpos as j_apply_xpos

jfa = importlib.import_module("kosmosx_tpu.ops.flash_attention")

B, H, D = 2, 3, 16
SHAPES = {"equal": (96, 96), "unequal": (80, 144)}  # (Lq, Lk)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(lq, lk, seed=0):
    rng = np.random.default_rng(seed)
    q, o, do = (rng.standard_normal((B, H, lq, D)).astype(np.float32)
                for _ in range(3))
    k = rng.standard_normal((B, H, lk, D)).astype(np.float32)
    return q, k, o, do


def _to_torch(x, dtype):
    """numpy fp32 -> torch in ``dtype``, rounded as jnp rounds it."""
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


def _ulp_bf16(x):
    """One bf16 step at each value's magnitude (2^-7 of its power of two)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prep_plain_rotation_matches_jax(shape, dtype):
    lq, lk = SHAPES[shape]
    jdt, tdt = DTYPES[dtype]
    q, k, o, do = _inputs(lq, lk)
    center = lq // 2
    q_sin, q_cos, k_sin, k_cos = jfa._xpos_tables(lq, lk, D, 512, center)
    rot = jfa._rot_matrix(D)

    def rotate(x, sin, cos):  # _apply_rot on each (L, D) head
        per_head = jax.vmap(jax.vmap(lambda y: jfa._apply_rot(y, sin, cos, rot)))
        return np.asarray(per_head(jnp.asarray(x, jdt)).astype(jnp.float32))

    with jax.default_matmul_precision("highest"):
        jq, jk = rotate(q, q_sin, q_cos), rotate(k, k_sin, k_cos)
    tq, tk, to, tdo = (_to_torch(x, tdt) for x in (q, k, o, do))
    q_r, k_r, _ = tfa.flash_bwd_prep(tq, tk, to, tdo, xpos_scale_base=512)
    assert q_r.dtype == tdt and k_r.dtype == tdt
    for got, want in ((q_r, jq), (k_r, jk)):
        got = got.float().numpy()
        if tdt == torch.float32:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        else:
            assert np.all(np.abs(got - want) <= _ulp_bf16(want)), \
                np.max(np.abs(got - want) / _ulp_bf16(want))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prep_plain_di_matches_jax(shape, dtype):
    """di = rowsum(o * do) in fp32 from inputs in the working dtype (the
    expression of kosmosx_tpu/ops/flash_attention.py:476); without xPos q and
    k pass through untouched."""
    lq, lk = SHAPES[shape]
    jdt, tdt = DTYPES[dtype]
    q, k, o, do = _inputs(lq, lk, seed=1)
    jo, jdo = jnp.asarray(o, jdt), jnp.asarray(do, jdt)
    want = np.asarray(jnp.sum(jo.astype(jnp.float32) * jdo.astype(jnp.float32),
                              axis=-1))
    tq, tk, to, tdo = (_to_torch(x, tdt) for x in (q, k, o, do))
    q_r, k_r, di = tfa.flash_bwd_prep(tq, tk, to, tdo)
    assert q_r is tq and k_r is tk
    assert di.dtype == torch.float32 and di.shape == (B, H, lq)
    np.testing.assert_allclose(di.numpy(), want, atol=1e-6, rtol=1e-6)


def _ragged(length, lengths):
    seg = np.where(np.arange(length)[None, :] < np.asarray(lengths)[:, None],
                   0, -1)
    return seg.astype(np.int32)


CASES = {
    "causal_xpos": dict(causal=True, xpos=True),
    "causal_padding": dict(causal=True, lengths=(128, 90)),
    "non_causal_xpos": dict(causal=False, xpos=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_composed_backward_matches_jax_grad(case):
    """pre-pass -> dK/dV and dQ plain versions, as ``flash_attention_bwd``
    runs them, against jax.grad of sum(o * do) through the Pallas kernels
    (interpret mode), fp32, 1e-4."""
    spec = CASES[case]
    length = 128
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal((B, H, length, D)).astype(np.float32)
                   for _ in range(4))
    seg = _ragged(length, spec["lengths"]) if "lengths" in spec else None
    kw = dict(causal=spec["causal"], sm_scale=D ** -0.5,
              xpos_scale_base=512 if spec.get("xpos") else None)
    seg_t = None if seg is None else torch.from_numpy(seg)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, l, m = tfa.flash_attention_fwd(tq, tk, tv, q_segment_ids=seg_t,
                                      kv_segment_ids=seg_t, **kw)
    before = (tfa.flash_bwd_prep.launches, tfa.flash_bwd_dkv.launches,
              tfa.flash_bwd_dq.launches)
    got = tfa.flash_attention_bwd(tq, tk, tv, o, l, m, tdo, q_segment_ids=seg_t,
                                  kv_segment_ids=seg_t, **kw)
    # plain versions on the CPU: no kernel counted
    assert (tfa.flash_bwd_prep.launches, tfa.flash_bwd_dkv.launches,
            tfa.flash_bwd_dq.launches) == before
    seg_j = None if seg is None else jnp.asarray(seg)

    def loss(q_, k_, v_):
        o_ = jfa.flash_attention(q_, k_, v_, causal=kw["causal"],
                                 sm_scale=kw["sm_scale"], q_segment_ids=seg_j,
                                 kv_segment_ids=seg_j, block_q=64, block_kv=64,
                                 interpret=True,
                                 xpos_scale_base=kw["xpos_scale_base"])
        return jnp.sum(o_ * jnp.asarray(do))

    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            *(jnp.asarray(x) for x in (q, k, v)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_prep_plain_matches_reference_rotation():
    """The pre-pass's fp32 q' against the xPos of kosmosx_tpu.nn.xpos on the
    whole sequence (the rotation the forward's reference path applies)."""
    q, k, o, do = _inputs(64, 64, seed=2)
    q_r, _, _ = tfa.flash_bwd_prep(*(torch.from_numpy(x) for x in (q, k, o, do)),
                                   xpos_scale_base=512)
    want = np.asarray(j_apply_xpos(jnp.asarray(q), scale_base=512, center=32))
    np.testing.assert_allclose(q_r.numpy(), want, atol=1e-5, rtol=1e-5)


def test_prep_refuses_devices_without_a_kernel():
    q = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_bwd_prep(q, q, q, q)
