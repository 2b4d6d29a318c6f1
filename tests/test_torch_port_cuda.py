"""The CUDA kernels of kosmosx_torch against their plain PyTorch versions.

These tests need an NVIDIA GPU (marker ``cuda``) and skip without one. This
file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the repo's conftest configures jax.) Bars: flash 1e-4 at
fp32 with TF32 off and 2e-2 at bf16; decode 1e-5 with an fp32 query, 2e-2 at
bf16 and 5e-2 with int8 codes and a bf16 query; the flash backward kernels
1e-4 (fp32) and 1e-2 (bf16) of each gradient's largest reference value; the
W8 matmuls 1e-5 (fp32) and 1e-2 (bf16: the plain version rounds the product
and the scaled result, the kernel once) of the largest reference value; the
tile-rate skeleton 1e-2 of the largest reference value (bf16 only).
"""

import dataclasses

import numpy as np
import pytest
import torch

import kosmosx_torch.core.config as tcfg
from kosmosx_torch.generate import sampler as tsamp
from kosmosx_torch.models.language import KosmosLanguage
from kosmosx_torch.ops import decode_attention as tdec
from kosmosx_torch.ops import flash_attention as tfa
from kosmosx_torch.ops import quant_matmul as tqm
from kosmosx_torch.ops import tile_rate as ttr
from kosmosx_torch.nn import layers as tlayers
from kosmosx_torch.utils.quantize import _quantize_w, quantize_params_w8

B, H = 2, 2
FLASH_CASES = {
    "causal": dict(causal=True),
    "causal_padding": dict(causal=True, lengths=(200, 150)),
    "fused_xpos": dict(causal=True, xpos=True),
    "non_causal": dict(causal=False),
}


def _quantize(x):
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8), scale


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(cuda, case, dtype, tol):
    spec = FLASH_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, H, 200, 64, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    seg = None
    if "lengths" in spec:
        seg = (torch.arange(200, device=cuda)[None] <
               torch.tensor(spec["lengths"], device=cuda)[:, None]).int() - 1
    kw = dict(causal=spec["causal"], sm_scale=0.125, q_segment_ids=seg,
              kv_segment_ids=seg,
              xpos_scale_base=512 if spec.get("xpos") else None,
              xpos_center=100)
    before = tfa.flash_attention.launches
    o, l, m = tfa.flash_attention_fwd(q, k, v, **kw)
    assert tfa.flash_attention.launches == before + 1
    o_p, l_p, m_p = tfa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (o.float() - o_p.float()).abs().max().item() < tol
    assert torch.allclose(m, m_p, atol=1e-3, rtol=1e-4)
    assert torch.allclose(l, l_p, atol=1e-3, rtol=1e-3)


def _flash_inputs(cuda, case, dtype, length=200, seed=0):
    spec = FLASH_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(B, H, length, 64, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    seg = None
    if "lengths" in spec:  # the case's lengths, scaled from 200 to length
        lengths = [n * length // 200 for n in spec["lengths"]]
        seg = (torch.arange(length, device=cuda)[None] <
               torch.tensor(lengths, device=cuda)[:, None]).int() - 1
    kw = dict(causal=spec["causal"], sm_scale=0.125, q_segment_ids=seg,
              kv_segment_ids=seg,
              xpos_scale_base=512 if spec.get("xpos") else None,
              xpos_center=length // 2)
    return q, k, v, kw


def _rel_err(a, ref):
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_flash_bwd_kernels_match_plain(cuda, case, dtype, tol):
    """dK/dV and dQ kernels against the plain versions on the same (o, l, m),
    each launched once per call, and bit-identical over two runs."""
    q, k, v, kw = _flash_inputs(cuda, case, dtype)
    o, l, m = tfa.flash_attention_fwd(q, k, v, **kw)
    do = torch.randn(o.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(1), device=cuda).to(dtype)
    before = (tfa.flash_bwd_dkv.launches, tfa.flash_bwd_dq.launches)
    grads = tfa.flash_attention_bwd(q, k, v, o, l, m, do, **kw)
    assert (tfa.flash_bwd_dkv.launches, tfa.flash_bwd_dq.launches) == \
        (before[0] + 1, before[1] + 1)
    again = tfa.flash_attention_bwd(q, k, v, o, l, m, do, **kw)
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, l, m, do, **kw)
    torch.cuda.synchronize()
    for name, a, b, r in zip(("dq", "dk", "dv"), grads, again, ref):
        assert a.dtype == dtype and a.shape == r.shape, name
        assert _rel_err(a, r) < tol, (name, _rel_err(a, r))
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_flash_bwd_kernels_with_unequal_lengths(cuda, causal, dtype, tol):
    """Lq = 100 queries over Lk = 177 keys (no tile multiples; under causal
    masking keys past Lq get dk = dv = 0)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, do = (torch.randn(B, H, 100, 64, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, H, 177, 64, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, sm_scale=0.125)
    o, l, m = tfa.flash_attention_fwd(q, k, v, **kw)
    grads = tfa.flash_attention_bwd(q, k, v, o, l, m, do, **kw)
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, l, m, do, **kw)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        assert _rel_err(a, r) < tol, (name, _rel_err(a, r))
    if causal:
        assert not grads[1][:, :, 100:].any() and not grads[2][:, :, 100:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_autograd_matches_plain_attention(cuda, case):
    """Gradients of the differentiable ``flash_attention`` (CUDA forward and
    backward kernels) against autograd through plain fp32 attention, at a
    ragged length of 77 (gradcheck-style agreement, 1e-4)."""
    q, k, v, kw = _flash_inputs(cuda, case, torch.float32, length=77, seed=2)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    do = torch.randn(q.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(3))
    o = tfa.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(o, (q, k, v), do)
    qr, kr = q, k
    if kw["xpos_scale_base"]:
        from kosmosx_torch.nn.xpos import apply_xpos
        qr = apply_xpos(q, scale_base=512, center=kw["xpos_center"])
        kr = apply_xpos(k, scale_base=512, downscale=True,
                        center=kw["xpos_center"])
    s = (qr @ kr.transpose(-1, -2)) * kw["sm_scale"]
    mask = tfa._mask(B, 77, 77, kw["causal"], kw["q_segment_ids"],
                     kw["kv_segment_ids"], cuda)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    ref = torch.autograd.grad(torch.softmax(s, -1) @ v, (q, k, v), do)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert _rel_err(a, r) < 1e-4, (name, _rel_err(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("kv,q_dtype,tol", [
    ("fp32", torch.float32, 1e-5), ("bf16", torch.bfloat16, 2e-2),
    ("int8", torch.bfloat16, 5e-2), ("int8", torch.float32, 1e-5)])
def test_decode_kernel_matches_plain(cuda, kv, q_dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(4, 8, 1, 64, generator=g, device=cuda).to(q_dtype)
    k = torch.randn(4, 8, 300, 64, generator=g, device=cuda)
    v = torch.randn(4, 8, 300, 64, generator=g, device=cuda)
    kv_len = torch.tensor([300, 77, 1, 0], device=cuda)
    kw = {}
    if kv == "int8":
        (k, ks), (v, vs) = (tuple(torch.from_numpy(a).to(cuda) for a in
                                  _quantize(t.cpu().numpy())) for t in (k, v))
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(q_dtype), v.to(q_dtype)
    before = tdec.decode_attention.launches
    o = tdec.decode_attention(q, k, v, kv_len, **kw)
    assert tdec.decode_attention.launches == before + 1
    ref = tdec.decode_attention_plain(q, k, v, kv_len, **kw)
    torch.cuda.synchronize()
    assert (o.float() - ref.float()).abs().max().item() < tol


@pytest.mark.cuda
def test_generation_takes_decode_kernel_at_any_cache_length(cuda):
    """A cache of 37 + 5 = 42 positions (not a multiple of 8): every decode
    step of every layer launches the decode kernel, and the greedy tokens
    equal those of the plain-attention path on the same weights."""
    cfg = tcfg.MagnetoConfig(vocab_size=97, embed_dim=128, ffn_dim=256,
                             layers=2, heads=2, dropout=0.0,
                             attention_dropout=0.0, decode_attn_kernel=True)
    g = torch.Generator(device=cuda).manual_seed(0)
    model = KosmosLanguage(cfg, generator=g, device=cuda)
    lengths = torch.tensor([37, 30, 21], device=cuda)
    prompt = torch.randint(4, 97, (3, 37), generator=g, device=cuda)
    prompt[torch.arange(37, device=cuda)[None] >= lengths[:, None]] = 1
    scfg = tsamp.SamplingConfig(max_new_tokens=5, greedy=True)
    before = tdec.decode_attention.launches
    out = tsamp.generate_text(model, cfg, prompt, scfg, prompt_lengths=lengths)
    assert tdec.decode_attention.launches - before == cfg.layers * 4
    plain = dataclasses.replace(cfg, decode_attn_kernel=False)
    ref = tsamp.generate_text(model, plain, prompt, scfg,
                              prompt_lengths=lengths)
    assert torch.equal(out, ref)


W8_SHAPES = [(1, 2048, 32002), (4, 2048, 2048), (5, 130, 70), (514, 588, 1024),
             (300, 640, 1100)]
W8_TOLS = [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", W8_SHAPES)
@pytest.mark.parametrize("dtype,tol", W8_TOLS)
def test_w8_matmul_kernel_matches_plain(cuda, m, k, n, dtype, tol):
    """Ragged shapes: the vocab head's N = 32002 (rows not 16-byte aligned),
    CLIP's K = 588, one decode row, a split-K decode shape."""
    g = torch.Generator(device=cuda).manual_seed(m)
    wq = _quantize_w(torch.randn(k, n, generator=g, device=cuda) * 0.3)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    before = tqm.w8_matmul.launches
    y = tqm.w8_matmul(x, wq["q"], wq["scale"])
    assert tqm.w8_matmul.launches == before + 1
    ref = tqm.w8_matmul_plain(x, wq["q"], wq["scale"])
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (m, n)
    assert _rel_err(y, ref) < tol, _rel_err(y, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 77])
@pytest.mark.parametrize("dtype,tol", W8_TOLS)
def test_w8_matmul_stacked_kernel_matches_plain(cuda, m, dtype, tol):
    """The first and last layer of a (3, 256, 384) stack, the index given as
    a host int and as a device scalar."""
    g = torch.Generator(device=cuda).manual_seed(m)
    wq = _quantize_w(torch.randn(3, 256, 384, generator=g, device=cuda) * 0.2)
    x = torch.randn(m, 256, generator=g, device=cuda).to(dtype)
    for li in (0, 2):
        before = tqm.w8_matmul_stacked.launches
        y = tqm.w8_matmul_stacked(x, wq["q"], wq["scale"], li)
        y2 = tqm.w8_matmul_stacked(x, wq["q"], wq["scale"], torch.tensor(
            li, dtype=torch.int32, device=cuda))
        assert tqm.w8_matmul_stacked.launches == before + 2
        ref = tqm.w8_matmul_plain(x, wq["q"][li], wq["scale"][li])
        torch.cuda.synchronize()
        assert _rel_err(y, ref) < tol, (li, _rel_err(y, ref))
        assert torch.equal(y, y2)


@pytest.mark.cuda
def test_w8_generation_takes_both_w8_kernels(cuda):
    """A W8 stacked-layout model generates through both W8 kernels (the
    vocab head 2-D, the decoder layers stacked) and gives the greedy tokens
    of the plain expression on the same codes."""
    cfg = tcfg.MagnetoConfig(vocab_size=97, embed_dim=128, ffn_dim=256,
                             layers=2, heads=2, dropout=0.0,
                             attention_dropout=0.0, decode_attn_kernel=True,
                             scan_layers=True)
    g = torch.Generator(device=cuda).manual_seed(0)
    model = quantize_params_w8(KosmosLanguage(cfg, generator=g, device=cuda))
    lengths = torch.tensor([37, 30, 21], device=cuda)
    prompt = torch.randint(4, 97, (3, 37), generator=g, device=cuda)
    prompt[torch.arange(37, device=cuda)[None] >= lengths[:, None]] = 1
    scfg = tsamp.SamplingConfig(max_new_tokens=5, greedy=True)
    before = (tqm.w8_matmul.launches, tqm.w8_matmul_stacked.launches)
    out = tsamp.generate_text(model, cfg, prompt, scfg, prompt_lengths=lengths)
    # 5 vocab-head calls; 6 linears x 2 layers x (prefill + 4 steps)
    assert (tqm.w8_matmul.launches - before[0],
            tqm.w8_matmul_stacked.launches - before[1]) == (5, 60)
    tlayers.set_w8_kernel("off")
    try:
        ref = tsamp.generate_text(model, cfg, prompt, scfg,
                                  prompt_lengths=lengths)
    finally:
        tlayers.set_w8_kernel("auto")
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("length", [64, 1024])
def test_tile_rate_kernel_matches_plain(cuda, d, g, length):
    """The tile-rate skeleton (S = Q K^T rounded to bf16, O = S V) against
    its plain version, 1e-2 of the largest reference value (S rounds to
    bf16 between the products, where the fp32 sum order can flip a
    rounding); one launch per call, two launches bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(g * length + d)
    q, k, v = (torch.randn(g, length, d, generator=gen, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    before = ttr.tile_attention_skeleton.launches
    o = ttr.tile_attention_skeleton(q, k, v)
    again = ttr.tile_attention_skeleton(q, k, v)
    assert ttr.tile_attention_skeleton.launches == before + 2
    ref = ttr.tile_attention_skeleton_plain(q, k, v)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and o.shape == (g, length, d)
    assert _rel_err(o, ref) < 1e-2, _rel_err(o, ref)
    assert torch.equal(o, again)
