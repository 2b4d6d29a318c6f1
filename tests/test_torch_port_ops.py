"""kosmosx_torch kernels' plain versions against the JAX Pallas kernels.

The same numpy inputs go through the JAX kernel (interpret mode, as the JAX
package's own tests run it on the CPU), its jnp oracle, and the port. On the
CPU the port's wrappers run their plain PyTorch versions; the CUDA kernels
themselves are compared with those plain versions on the card
(``chip_smoke.py``, and the ``cuda``-marked tests below). Bars: 1e-4 at fp32
with jax matmul precision "highest", as tests/test_torch_parity.py:48.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kosmosx_torch.ops import decode_attention as tdec
from kosmosx_torch.ops import flash_attention as tfa
from kosmosx_torch.ops.fast_gelu import gelu_fast as t_gelu_fast
from kosmosx_tpu.nn.xpos import apply_xpos as j_apply_xpos
from kosmosx_tpu.ops.fast_gelu import gelu_fast as j_gelu_fast

# kosmosx_tpu.ops re-exports functions under the modules' names
jdec = importlib.import_module("kosmosx_tpu.ops.decode_attention")
jfa = importlib.import_module("kosmosx_tpu.ops.flash_attention")

TOL = dict(atol=1e-4, rtol=1e-4)
B, H, L, D = 2, 2, 256, 16
BLOCK = 128


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, D)).astype(np.float32)
            for _ in range(3)]


def _ragged_segments(lengths):
    seg = np.where(np.arange(L)[None, :] < np.asarray(lengths)[:, None], 0, -1)
    return seg.astype(np.int32)


FLASH_CASES = {
    "causal": dict(causal=True),
    "causal_padding": dict(causal=True, lengths=(L, 150)),
    "fused_xpos": dict(causal=True, xpos=True),
    "non_causal": dict(causal=False),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax_kernel(case):
    """o, l and m of the plain flash forward equal the Pallas forward's
    (interpret mode) and o equals mha_reference."""
    spec = FLASH_CASES[case]
    causal, xpos = spec["causal"], spec.get("xpos", False)
    q, k, v = _qkv(0)
    sm_scale = D ** -0.5
    seg = _ragged_segments(spec["lengths"]) if "lengths" in spec else None
    center = L // 2
    with jax.default_matmul_precision("highest"):
        qs = ks = tables = None
        if seg is not None:
            qs = jnp.broadcast_to(jnp.asarray(seg)[:, :, None], (B, L, 8))
            ks = jnp.broadcast_to(jnp.asarray(seg)[:, None, :], (B, 8, L))
        if xpos:
            tables = jfa._xpos_tables(L, L, D, 512, center)
        o_j, l_j, m_j = jfa._fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qs, ks, tables,
            causal=causal, sm_scale=sm_scale, block_q=BLOCK, block_kv=BLOCK,
            mask_value=jfa.DEFAULT_MASK_VALUE, interpret=True)
        qr, kr = jnp.asarray(q), jnp.asarray(k)
        if xpos:
            qr = j_apply_xpos(qr, scale_base=512, center=center)
            kr = j_apply_xpos(kr, scale_base=512, downscale=True, center=center)
        seg_j = None if seg is None else jnp.asarray(seg)
        ref = jfa.mha_reference(qr, kr, jnp.asarray(v), causal=causal,
                                sm_scale=sm_scale, q_segment_ids=seg_j,
                                kv_segment_ids=seg_j)
    seg_t = None if seg is None else torch.from_numpy(seg)
    o, l, m = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, sm_scale=sm_scale, q_segment_ids=seg_t,
        kv_segment_ids=seg_t, xpos_scale_base=512 if xpos else None)
    np.testing.assert_allclose(o.numpy(), _np(o_j), **TOL)
    np.testing.assert_allclose(o.numpy(), _np(ref), **TOL)
    np.testing.assert_allclose(l.numpy(), _np(l_j)[..., 0], **TOL)
    np.testing.assert_allclose(m.numpy(), _np(m_j)[..., 0], **TOL)


def _flash_grad_inputs(case):
    """Inputs of one FLASH_CASES entry and the cotangent of o."""
    spec = FLASH_CASES[case]
    q, k, v = _qkv(0)
    do = np.random.default_rng(7).standard_normal((B, H, L, D)).astype(
        np.float32)
    seg = _ragged_segments(spec["lengths"]) if "lengths" in spec else None
    kw = dict(causal=spec["causal"], sm_scale=D ** -0.5,
              xpos_scale_base=512 if spec.get("xpos") else None)
    return q, k, v, do, seg, kw


def _jax_flash_grads(q, k, v, do, seg, kw):
    """jax.grad of sum(o * do) through the Pallas kernels (interpret mode)
    and through mha_reference on the xPos-rotated q/k."""
    seg_j = None if seg is None else jnp.asarray(seg)
    xpos = kw["xpos_scale_base"] is not None

    def pallas(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, causal=kw["causal"],
                                sm_scale=kw["sm_scale"], q_segment_ids=seg_j,
                                kv_segment_ids=seg_j, block_q=BLOCK,
                                block_kv=BLOCK, interpret=True,
                                xpos_scale_base=kw["xpos_scale_base"])
        return jnp.sum(o * jnp.asarray(do))

    def reference(q_, k_, v_):
        if xpos:
            q_ = j_apply_xpos(q_, scale_base=512, center=L // 2)
            k_ = j_apply_xpos(k_, scale_base=512, downscale=True, center=L // 2)
        o = jfa.mha_reference(q_, k_, v_, causal=kw["causal"],
                              sm_scale=kw["sm_scale"], q_segment_ids=seg_j,
                              kv_segment_ids=seg_j)
        return jnp.sum(o * jnp.asarray(do))

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    with jax.default_matmul_precision("highest"):
        return (jax.jit(jax.grad(pallas, argnums=(0, 1, 2)))(*args),
                jax.jit(jax.grad(reference, argnums=(0, 1, 2)))(*args))


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_matches_jax_kernels(case):
    """dq, dk, dv of the plain backward (from the port's (o, l, m)) and of
    the autograd Function on CPU tensors equal jax.grad through the Pallas
    backward kernels (interpret mode) and through mha_reference."""
    q, k, v, do, seg, kw = _flash_grad_inputs(case)
    seg_t = None if seg is None else torch.from_numpy(seg)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, l, m = tfa.flash_attention_fwd(tq, tk, tv, q_segment_ids=seg_t,
                                      kv_segment_ids=seg_t, **kw)
    plain = tfa.flash_attention_bwd_plain(tq, tk, tv, o, l, m,
                                          torch.from_numpy(do),
                                          q_segment_ids=seg_t,
                                          kv_segment_ids=seg_t, **kw)
    o_fn = tfa.flash_attention(tq, tk, tv, q_segment_ids=seg_t,
                               kv_segment_ids=seg_t, **kw)
    autograd = torch.autograd.grad(o_fn, (tq, tk, tv), torch.from_numpy(do))
    pallas, reference = _jax_flash_grads(q, k, v, do, seg, kw)
    for name, p_, a_, gp, gr in zip(("dq", "dk", "dv"), plain, autograd,
                                     pallas, reference):
        np.testing.assert_allclose(p_.detach().numpy(), _np(gp), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(p_.detach().numpy(), _np(gr), **TOL,
                                   err_msg=name)
        np.testing.assert_array_equal(a_.numpy(), p_.detach().numpy(),
                                      err_msg=name)


def test_flash_backward_of_a_row_with_no_visible_key_is_zero():
    """A query whose segment matches no key gets dq = 0, and a key no query
    sees gets dk = dv = 0."""
    q, k, v, do = (torch.randn(1, 1, 4, 64) for _ in range(4))
    qseg = torch.tensor([[0, 0, 1, 0]])
    kseg = torch.tensor([[0, 2, 0, 0]])
    kw = dict(causal=False, q_segment_ids=qseg, kv_segment_ids=kseg)
    o, l, m = tfa.flash_attention_fwd(q, k, v, **kw)
    dq, dk, dv = tfa.flash_attention_bwd_plain(q, k, v, o, l, m, do, **kw)
    assert torch.all(dq[0, 0, 2] == 0) and torch.all(dq[0, 0, [0, 1, 3]] != 0)
    assert torch.all(dk[0, 0, 1] == 0) and torch.all(dv[0, 0, 1] == 0)


def test_flash_wrapper_ragged_length_matches_jax():
    """The public wrappers at a length that is no tile multiple (the JAX
    wrapper pads it, the port bounds it): same o on every row."""
    rng = np.random.default_rng(3)
    q, k, v = [rng.standard_normal((1, 2, 200, 16)).astype(np.float32)
               for _ in range(3)]
    with jax.default_matmul_precision("highest"):
        o_j = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, sm_scale=0.25,
                                  interpret=True, xpos_scale_base=512)
    o = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True, sm_scale=0.25,
                            xpos_scale_base=512)
    np.testing.assert_allclose(o.numpy(), _np(o_j), **TOL)


def test_flash_row_with_no_visible_key_is_zero():
    """A query whose segment matches no key returns 0 with l == 0."""
    q, k, v = (torch.randn(1, 1, 4, 64) for _ in range(3))
    qseg = torch.tensor([[0, 0, 1, 0]])
    kseg = torch.tensor([[0, 0, 0, 0]])
    o, l, _ = tfa.flash_attention_fwd(q, k, v, causal=False,
                                      q_segment_ids=qseg, kv_segment_ids=kseg)
    assert torch.all(o[0, 0, 2] == 0) and l[0, 0, 2] == 0
    assert torch.all(l[0, 0, [0, 1, 3]] > 0)


def _quantize(x):
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8), scale


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_decode_plain_matches_jax_kernel(int8):
    rng = np.random.default_rng(1)
    b, h, s, hd = 3, 4, 64, 16
    q = rng.standard_normal((b, h, 1, hd)).astype(np.float32)
    k = rng.standard_normal((b, h, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, h, s, hd)).astype(np.float32)
    kv_len = np.array([s, 20, 1], np.int32)
    scales = {}
    if int8:
        k, ks = _quantize(k)
        v, vs = _quantize(v)
        scales = dict(k_scale=ks, v_scale=vs)
    jargs = {n: jnp.asarray(a) for n, a in scales.items()}
    with jax.default_matmul_precision("highest"):
        o_j = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(kv_len),
                                    block_s=16, interpret=True, **jargs)
        ref = jdec.decode_attention_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(kv_len), **jargs)
    o = tdec.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_len),
        **{n: torch.from_numpy(a) for n, a in scales.items()})
    np.testing.assert_allclose(o.numpy(), _np(ref), **TOL)
    # the Pallas kernel rounds nothing here (fp32 q), but sums int8 products
    # in another order: 1e-4 holds for both
    np.testing.assert_allclose(o.numpy(), _np(o_j), **TOL)


def test_decode_empty_row_is_zero():
    q, k, v = torch.randn(2, 1, 1, 64), torch.randn(2, 1, 8, 64), torch.randn(2, 1, 8, 64)
    o = tdec.decode_attention(q, k, v, torch.tensor([0, 8]))
    assert torch.all(o[0] == 0) and torch.all(o[1] != 0)


def test_gelu_fast_matches_jax():
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    np.testing.assert_allclose(t_gelu_fast(torch.from_numpy(x)).numpy(),
                               _np(j_gelu_fast(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("fn", ["flash", "decode"])
def test_wrappers_refuse_devices_without_a_kernel(fn):
    """Only CPU tensors take the plain version: any other device without
    CUDA raises instead of falling back."""
    q = torch.empty(1, 1, 1, 64, device="meta")
    k = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        if fn == "flash":
            tfa.flash_attention(q, k, k)
        else:
            tdec.decode_attention(q, k, k, torch.empty(1, device="meta"))
