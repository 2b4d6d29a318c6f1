"""The CUDA kernels of kosmosx_torch against their plain PyTorch versions.

These tests need an NVIDIA GPU (marker ``cuda``) and skip without one. This
file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the repo's conftest configures jax.) Bars: flash 1e-4 at
fp32 with TF32 off and 2e-2 at bf16; decode 1e-5 with an fp32 query, 2e-2 at
bf16 and 5e-2 with int8 codes and a bf16 query (two launches and a CUDA-graph
replay bit-identical: the chunks merge in a fixed order); the flash backward kernels
1e-4 (fp32) and 1e-2 (bf16) of each gradient's largest reference value, its
pre-pass bit-identical in q' and k' and 1e-5 in di; the
W8 matmuls 1e-5 (fp32) and 1e-2 (bf16: the plain version rounds the product
and the scaled result, the kernels once) of the largest reference value; the
tile-rate skeleton 1e-2 of the largest reference value (bf16 only); the
LayerNorm kernels 1e-5 of the largest reference value in fp32, and in bf16
and fp16 outputs within one ulp of their type (counted no finer than at
1/256 of the largest value: a near-zero output is a difference of O(1)
terms whose fp32 roundings exceed its own ulp), dx within 1e-2 of its
largest value, fp32 parameter gradients within 1e-3 of theirs (bf16 and
fp16 ones within one ulp: both sides round an fp32 sum), two backward runs
bit-identical.
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
from kosmosx_torch.ops import layer_norm as tln
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
    # one id everywhere, as in the training batches: every tile inside the
    # lengths and below the diagonal takes no mask
    "uniform_ids": dict(causal=True, xpos=True, ids="uniform"),
    # packed documents whose ids change inside a tile
    "mixed_ids": dict(causal=True, xpos=True, ids="packed"),
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


def _segment_ids(spec, length, device):
    """The case's segment ids (B, length), or None: padding from the case's
    lengths (scaled from 200 to ``length``), one id, or packed documents
    (row 0 changes id at 15% and 65% of the length, row 1 every quarter)."""
    pos = torch.arange(length, device=device)[None]
    if "lengths" in spec:
        lengths = [n * length // 200 for n in spec["lengths"]]
        return (pos < torch.tensor(lengths, device=device)[:, None]).int() - 1
    if spec.get("ids") == "uniform":
        return torch.zeros(B, length, dtype=torch.int32, device=device)
    if spec.get("ids") == "packed":
        row0 = (pos >= 30 * length // 200).int() + (pos >= 130 * length // 200).int()
        row1 = pos * 4 // length
        return torch.cat([row0, row1]).int()
    return None


def _flash_inputs(cuda, case, dtype, length=200, seed=0):
    spec = FLASH_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(B, H, length, 64, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    seg = _segment_ids(spec, length, cuda)
    kw = dict(causal=spec["causal"], sm_scale=0.125, q_segment_ids=seg,
              kv_segment_ids=seg,
              xpos_scale_base=512 if spec.get("xpos") else None,
              xpos_center=length // 2)
    return q, k, v, kw


def _check_forward(q, k, v, kw, tol):
    """One forward against the plain version: o within ``tol``, (l, m) at
    chip_smoke.py's bars; one forward launch, and one launch of the rotation
    kernel exactly where the call is bf16 with xPos."""
    before = (tfa.flash_attention.launches, tfa.flash_fwd_prep.launches)
    o, l, m = tfa.flash_attention_fwd(q, k, v, **kw)
    rotates = int(q.dtype == torch.bfloat16
                  and kw.get("xpos_scale_base") is not None)
    assert (tfa.flash_attention.launches, tfa.flash_fwd_prep.launches) == \
        (before[0] + 1, before[1] + rotates)
    o_p, l_p, m_p = tfa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == q.dtype and o.shape == q.shape
    assert (o.float() - o_p.float()).abs().max().item() < tol
    assert torch.allclose(m, m_p, atol=1e-3, rtol=1e-4)
    assert torch.allclose(l, l_p, atol=1e-3, rtol=1e-3)
    return o, l, m


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(cuda, case, dtype, tol):
    q, k, v, kw = _flash_inputs(cuda, case, dtype)
    _check_forward(q, k, v, kw, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_long_sequence(cuda, case):
    """bf16 at L = 2048, H = 2: 16 blocks of 128 q rows per head, 32 kv
    tiles through the ring, which wraps many times."""
    q, k, v, kw = _flash_inputs(cuda, case, torch.bfloat16, length=2048, seed=8)
    _check_forward(q, k, v, kw, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(100, 177), (177, 100), (40, 23)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_with_unequal_lengths(cuda, lq, lk, causal, dtype, tol):
    """Lq != Lk with xPos, no tile multiples; at Lq = 40 over Lk = 23 each
    TMA box of 64 rows is longer than its head's rows, which read as
    zeros."""
    g = torch.Generator(device=cuda).manual_seed(lq * lk)
    q = torch.randn(B, H, lq, 64, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, H, lk, 64, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    _check_forward(q, k, v, dict(causal=causal, sm_scale=0.125,
                                 xpos_scale_base=512, xpos_center=lq // 2), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_row_with_no_visible_key(cuda, dtype, tol):
    """q rows whose id no kv row holds (every seventh) see nothing: o = 0
    and l = 0 there, the other rows as the plain version."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(B, H, 200, 64, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    kv_ids = torch.zeros(B, 200, dtype=torch.int32, device=cuda)
    orphan = torch.arange(200, device=cuda) % 7 == 3
    q_ids = torch.where(orphan, 5, 0).int()[None].expand(B, 200).contiguous()
    o, l, _ = _check_forward(q, k, v, dict(causal=True, sm_scale=0.125,
                                           q_segment_ids=q_ids,
                                           kv_segment_ids=kv_ids), tol)
    assert not o[:, :, orphan].any() and not l[:, :, orphan].any()
    assert bool((l[:, :, ~orphan] > 0).all())


def _rel_err(a, ref):
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_flash_bwd_kernels_match_plain(cuda, case, dtype, tol):
    """dK/dV and dQ kernels against the plain versions on the same (o, l, m),
    each launched once per call with one pre-pass, and bit-identical over two
    runs."""
    q, k, v, kw = _flash_inputs(cuda, case, dtype)
    o, l, m = tfa.flash_attention_fwd(q, k, v, **kw)
    do = torch.randn(o.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(1), device=cuda).to(dtype)
    before = _bwd_launches()
    grads = tfa.flash_attention_bwd(q, k, v, o, l, m, do, **kw)
    assert _bwd_launches() == tuple(n + 1 for n in before)
    again = tfa.flash_attention_bwd(q, k, v, o, l, m, do, **kw)
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, l, m, do, **kw)
    torch.cuda.synchronize()
    for name, a, b, r in zip(("dq", "dk", "dv"), grads, again, ref):
        assert a.dtype == dtype and a.shape == r.shape, name
        assert _rel_err(a, r) < tol, (name, _rel_err(a, r))
        assert torch.equal(a, b), name


def _bwd_launches():
    return (tfa.flash_bwd_prep.launches, tfa.flash_bwd_dkv.launches,
            tfa.flash_bwd_dq.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_bwd_kernels_long_sequence(cuda, case):
    """bf16 at L = 2048, H = 2: 32 q tiles stream through the dK/dV ring and
    32 kv tiles through the dQ ring, which wrap many times."""
    q, k, v, kw = _flash_inputs(cuda, case, torch.bfloat16, length=2048, seed=5)
    o, l, m = tfa.flash_attention_fwd(q, k, v, **kw)
    do = torch.randn(o.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(6), device=cuda).to(torch.bfloat16)
    before = _bwd_launches()
    grads = tfa.flash_attention_bwd(q, k, v, o, l, m, do, **kw)
    assert _bwd_launches() == tuple(n + 1 for n in before)
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, l, m, do, **kw)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        assert _rel_err(a, r) < 1e-2, (name, _rel_err(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(200, 200), (100, 177)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xpos", [True, False], ids=["xpos", "no_xpos"])
def test_flash_bwd_prep_kernel_matches_plain(cuda, lq, lk, dtype, xpos):
    """The pre-pass: q' and k' bit-identical to the plain version's rotation,
    di within 1e-5 of its largest value; one launch per call. Without xPos,
    q and k pass through."""
    g = torch.Generator(device=cuda).manual_seed(lq + lk)
    q, o, do = (torch.randn(B, H, lq, 64, generator=g, device=cuda).to(dtype)
                for _ in range(3))
    k = torch.randn(B, H, lk, 64, generator=g, device=cuda).to(dtype)
    kw = dict(xpos_scale_base=512 if xpos else None, xpos_center=lq // 2)
    before = tfa.flash_bwd_prep.launches
    q_r, k_r, di = tfa.flash_bwd_prep(q, k, o, do, **kw)
    assert tfa.flash_bwd_prep.launches == before + 1
    ref_q, ref_k, ref_di = tfa.flash_bwd_prep_plain(q, k, o, do, **kw)
    torch.cuda.synchronize()
    assert q_r.dtype == dtype and k_r.dtype == dtype
    assert torch.equal(q_r, ref_q) and torch.equal(k_r, ref_k)
    if not xpos:
        assert q_r is q and k_r is k
    assert _rel_err(di, ref_di) < 1e-5, _rel_err(di, ref_di)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_flash_bwd_wrappers_alone(cuda, dtype, tol):
    """``flash_bwd_dkv`` and ``flash_bwd_dq`` called alone with raw q and k
    and fused xPos: a bf16 call runs the pre-pass for q' and k' first (one
    prep launch each), an fp32 call rotates in the kernel."""
    q, k, v, kw = _flash_inputs(cuda, "fused_xpos", dtype)
    o, l, m = tfa.flash_attention_fwd(q, k, v, **kw)
    do = torch.randn(o.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(1), device=cuda).to(dtype)
    di = tfa._di(o, do)
    before = _bwd_launches()
    dk, dv = tfa.flash_bwd_dkv(q, k, v, l, m, di, do, **kw)
    dq = tfa.flash_bwd_dq(q, k, v, l, m, di, do, **kw)
    preps = 2 if dtype == torch.bfloat16 else 0
    assert _bwd_launches() == (before[0] + preps, before[1] + 1, before[2] + 1)
    ref_dk, ref_dv = tfa.flash_bwd_dkv_plain(q, k, v, l, m, di, do, **kw)
    ref_dq = tfa.flash_bwd_dq_plain(q, k, v, l, m, di, do, **kw)
    torch.cuda.synchronize()
    for name, a, r in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert _rel_err(a, r) < tol, (name, _rel_err(a, r))


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
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
def test_flash_bwd_kernels_shorter_than_a_tile(cuda, causal):
    """bf16 with fused xPos at Lq = 40 over Lk = 23: each TMA box of 64 rows
    is longer than its head's rows, which read as zeros."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, do = (torch.randn(B, H, 40, 64, generator=g, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, H, 23, 64, generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=causal, sm_scale=0.125, xpos_scale_base=512)
    o, l, m = tfa.flash_attention_fwd(q, k, v, **kw)
    grads = tfa.flash_attention_bwd(q, k, v, o, l, m, do, **kw)
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, l, m, do, **kw)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        assert _rel_err(a, r) < 1e-2, (name, _rel_err(a, r))


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


DECODE_PAIRS = [("fp32", torch.float32, 1e-5), ("bf16", torch.bfloat16, 2e-2),
                ("int8", torch.bfloat16, 5e-2), ("int8", torch.float32, 1e-5)]


def _decode_inputs(cuda, b, h, s_len, kv, q_dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = (torch.randn(b, h, 1, 64, generator=g, device=cuda) / 8).to(q_dtype)
    k = torch.randn(b, h, s_len, 64, generator=g, device=cuda)
    v = torch.randn(b, h, s_len, 64, generator=g, device=cuda)
    if kv != "int8":
        return q, k.to(q_dtype), v.to(q_dtype), {}
    (k, ks), (v, vs) = (tuple(torch.from_numpy(a).to(cuda) for a in
                              _quantize(t.cpu().numpy())) for t in (k, v))
    return q, k, v, dict(k_scale=ks, v_scale=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("s_len", [23, 259, 2049])
@pytest.mark.parametrize("kv,q_dtype,tol", DECODE_PAIRS)
def test_decode_kernel_chunk_edges(cuda, s_len, kv, q_dtype, tol):
    """kv_len at 0, 1 and around the chunk edges (C - 1, C, C + 1, 2C) and
    at S, with S not a multiple of C: the split-S kernel against the plain
    version and the split arithmetic, an empty row exactly 0, two launches
    and a CUDA-graph replay bit-identical."""
    c = tdec.CHUNK
    lens = sorted({min(n, s_len) for n in (0, 1, c - 1, c, c + 1, 2 * c, s_len)})
    kv_len = torch.tensor(lens, device=cuda)
    q, k, v, kw = _decode_inputs(cuda, len(lens), 3, s_len, kv, q_dtype)
    o = tdec.decode_attention(q, k, v, kv_len, **kw)
    again = tdec.decode_attention(q, k, v, kv_len, **kw)
    ref = tdec.decode_attention_plain(q, k, v, kv_len, **kw)
    split = tdec.decode_attention_split_plain(q, k, v, kv_len, chunk=c, **kw)
    static = torch.empty_like(o)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tdec.decode_attention(q, k, v, kv_len, **kw)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        static.copy_(tdec.decode_attention(q, k, v, kv_len, **kw))
    graph.replay()
    torch.cuda.synchronize()
    for want in (ref, split):
        assert (o.float() - want.float()).abs().max().item() < tol
    assert torch.all(o[0] == 0)
    assert torch.equal(o, again) and torch.equal(o, static)


@pytest.mark.cuda
def test_decode_graph_keeps_its_tickets_when_a_call_needs_more(cuda):
    """A decode launch captured in a CUDA graph keeps its ticket buffer: an
    eager call with more (b, h) rows than the buffer holds gets a larger
    one, and the graph's replay still gives the captured call's result.
    Needing more tickets during a capture raises."""
    q, k, v, _ = _decode_inputs(cuda, 2, 4, 300, "bf16", torch.bfloat16)
    kv_len = torch.tensor([300, 150], device=cuda)
    o = tdec.decode_attention(q, k, v, kv_len)
    static = torch.empty_like(o)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tdec.decode_attention(q, k, v, kv_len)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        static.copy_(tdec.decode_attention(q, k, v, kv_len))
    dev = q.device  # the tickets are kept by device index
    have = tqm._tickets(dev, 1).numel()
    b, h = have // 32 + 1, 32
    qb, kb, vb, _ = _decode_inputs(cuda, b, h, 300, "bf16", torch.bfloat16,
                                   seed=1)
    lens = torch.full((b,), 300, device=cuda)
    big = tdec.decode_attention(qb, kb, vb, lens)
    ref = tdec.decode_attention_plain(qb, kb, vb, lens)
    assert tqm._tickets(dev, 1).numel() > have
    del qb, kb, vb
    static.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert (big.float() - ref.float()).abs().max().item() < 2e-2
    assert torch.equal(static, o)
    more = tqm._tickets(dev, 1).numel() + 1
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            tqm._tickets(dev, more)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", [(1, 1), (3, 5), (8, 32), (2, 128)])
@pytest.mark.parametrize("kv,q_dtype,tol", DECODE_PAIRS)
def test_decode_kernel_heads(cuda, b, h, kv, q_dtype, tol):
    """B * H from 1 to 256 over a 700-position cache with ragged lengths:
    one launch counted, the plain version's result."""
    q, k, v, kw = _decode_inputs(cuda, b, h, 700, kv, q_dtype, seed=b * h)
    kv_len = torch.tensor([700, 333, 129][:b] + [1] * max(0, b - 3),
                          device=cuda)
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


CACHE_MODES = {"int8": dict(int8=True, window=0),
               "ring": dict(int8=False, window=40),
               "ring_int8": dict(int8=True, window=40)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(CACHE_MODES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cache_writes_and_decode_kernel_match_plain(cuda, mode, dtype, tol):
    """Self-attention steps on the card, one over an int8 cache and/or a
    ring of 40 slots (4 sinks) that wraps: a chunk of 30 at index 0 (the
    flash kernel is off below 256), then 60 one-token steps at ragged
    indices, each through the decode kernel and through plain attention on
    a copy of the same cache. Outputs agree within ``tol`` of their largest
    value, the caches the two write are identical, and the int8 codes and
    scales of the last step's k are ``_quantize_kv``'s on the CPU."""
    from kosmosx_torch.nn import attention as tattn

    spec = CACHE_MODES[mode]
    g = torch.Generator(device=cuda).manual_seed(1)
    heads, d = 4, 256
    params = tattn.init_self_attention(g, d, heads, device=cuda)
    params = {k: {kk: vv.to(dtype) for kk, vv in v.items()}
              for k, v in params.items()}
    s_len = spec["window"] or 96
    shape = (2, heads, s_len, 64)
    if spec["int8"]:
        cache = {"k": torch.zeros(shape, dtype=torch.int8, device=cuda),
                 "k_scale": torch.ones(shape[:-1] + (1,), device=cuda),
                 "v": torch.zeros(shape, dtype=torch.int8, device=cuda),
                 "v_scale": torch.ones(shape[:-1] + (1,), device=cuda)}
    else:
        cache = {n: torch.zeros(shape, dtype=dtype, device=cuda)
                 for n in ("k", "v")}
    plain = {n: t.clone() for n, t in cache.items()}
    kw = dict(heads=heads, multiway=False, xpos=True, use_flash=False,
              kv_window=spec["window"], kv_sink=4, dtype=dtype)
    x = torch.randn(2, 30, d, generator=g, device=cuda).to(dtype)
    for c in (cache, plain):
        tattn.self_attention(params, x, cache=c, cache_index=0, **kw)
    idx = torch.tensor([30, 21], device=cuda)
    steps = 60 if spec["window"] else 50
    before = tdec.decode_attention.launches
    for _ in range(steps):
        x = torch.randn(2, 1, d, generator=g, device=cuda).to(dtype)
        o = tattn.self_attention(params, x, cache=cache, cache_index=idx,
                                 decode_attn_kernel=True, **kw)
        ref = tattn.self_attention(params, x, cache=plain, cache_index=idx,
                                   **kw)
        torch.cuda.synchronize()
        assert _rel_err(o, ref) < tol, (idx.tolist(), _rel_err(o, ref))
        idx = idx + 1
    assert tdec.decode_attention.launches - before == steps
    for n in cache:
        assert torch.equal(cache[n], plain[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_cache_write_matches_cpu(cuda, dtype):
    """The int8 write path on the card, at ring slots and at a chunk's
    slots: codes and scales bit-identical to the same write on the CPU."""
    from kosmosx_torch.nn import attention as tattn

    g = torch.Generator().manual_seed(3)
    k, v = (torch.randn(3, 4, 5, 64, generator=g).to(dtype) * 3
            for _ in range(2))
    k[0, 1, 2] = 0.0
    pos = torch.tensor([[0, 1, 2, 3, 4], [9, 10, 11, 12, 13], [4, 7, 5, 6, 8]])
    shape = (3, 4, 16, 64)
    caches = []
    for dev in ("cpu", cuda):
        cache = {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "k_scale": torch.ones(shape[:-1] + (1,), device=dev),
                 "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "v_scale": torch.ones(shape[:-1] + (1,), device=dev)}
        tattn._write_cache(cache, k.to(dev), v.to(dev), pos.to(dev))
        caches.append(cache)
    for n in caches[0]:
        assert torch.equal(caches[1][n].cpu(), caches[0][n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kv_quantization_matches_cpu(cuda, dtype):
    """``_quantize_kv`` on the card: codes and scales bit-identical to the
    CPU's (which the CPU tests hold bit-identical to JAX's), at the cache
    shape of one flagship decode step and with zero rows."""
    from kosmosx_torch.nn import attention as tattn

    g = torch.Generator().manual_seed(4)
    x = (torch.randn(4, 32, 544, 64, generator=g) * 4).to(dtype)
    x[0, 0, :3] = 0.0
    cpu = tattn._quantize_kv(x)
    card = tattn._quantize_kv(x.to(cuda))
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8_quantization_matches_cpu(cuda, dtype):
    """W8 codes and scales made on the card are the CPU's (which the CPU
    tests hold bit-identical to JAX's): a (2048, 8192) weight and a
    (1000, 512) table."""
    from kosmosx_torch.utils.quantize import _quantize_table

    g = torch.Generator().manual_seed(5)
    for fn, shape in ((_quantize_w, (2048, 8192)), (_quantize_table, (1000, 512))):
        w = (torch.randn(shape, generator=g) * 0.02).to(dtype)
        cpu, card = fn(w), fn(w.to(cuda))
        for key in ("q", "scale"):
            assert torch.equal(card[key].cpu(), cpu[key]), (fn.__name__, key)


@pytest.mark.cuda
def test_recentered_decode_step_matches_on_the_card(cuda):
    """A bf16 ring cache of a 2-layer decoder after 300 steps (wrapped),
    re-centered by 4096 positions with ``xpos_center`` moved as much: its
    decode step's logits through the kernel within 2e-2 (relative
    Frobenius) of the step without re-centering."""
    from kosmosx_torch.nn import decoder as tdecoder

    cfg = tcfg.MagnetoConfig(vocab_size=97, embed_dim=256, ffn_dim=512,
                             layers=2, heads=4, dropout=0.0,
                             attention_dropout=0.0, kv_window=128, kv_sink=4,
                             decode_attn_kernel=True, compute_dtype="bfloat16")
    g = torch.Generator(device=cuda).manual_seed(2)
    model = KosmosLanguage(cfg, generator=g, device=cuda).to(torch.bfloat16)
    prompt = torch.randint(4, 97, (2, 20), generator=g, device=cuda)
    x, _ = tdecoder.forward_embedding(model, cfg, prompt)
    lengths = torch.tensor([20, 17], device=cuda)
    with torch.inference_mode():
        _, state = tsamp._generate(model, cfg, x, lengths,
                                   tsamp.SamplingConfig(max_new_tokens=300,
                                                        greedy=True),
                                   cfg.kv_window, None, False)

        def step(caches, center):
            return tsamp._decode_logits(
                model, cfg, state.tok[:, None],
                [{n: t.clone() for n, t in c.items()} for c in caches],
                state.index, xpos_center=center)[:, 0].float()

        ref = step(state.caches, state.center)
        moved = tdecoder.recenter_caches(state.caches, 4096, cfg)
        got = step(moved, state.center + 4096)
    torch.cuda.synchronize()
    assert int(state.index.min()) > cfg.kv_window
    assert bool(torch.isfinite(got).all())
    rel = ((got - ref).norm() / ref.norm()).item()
    assert rel < 2e-2, rel


W8_SHAPES = [(1, 2048, 32002), (4, 2048, 2048), (5, 130, 70), (514, 588, 1024),
             (300, 640, 1100)]
W8_TOLS = [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", W8_SHAPES)
@pytest.mark.parametrize("dtype,tol", W8_TOLS)
def test_w8_matmul_kernel_matches_plain(cuda, m, k, n, dtype, tol):
    """Ragged shapes: the vocab head's N = 32002 (on padded codes, the
    Hopper kernel), CLIP's K = 588, one decode row, a split-K decode
    shape, and padded codes of N = 70 (K = 130: the mma.sync kernel) and
    N = 1100 (the Hopper kernel at bf16)."""
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
@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
@pytest.mark.parametrize("dtype,tol", W8_TOLS)
def test_w8_matmul_under_autograd_matches_plain(cuda, stacked, dtype, tol):
    """Where x requires a gradient the wrappers launch the kernel through
    the ``w8_product`` operator: a grad_fn on the output, one launch, and
    ``dx`` within the bar of ``w8_matmul_plain``'s autograd on padded
    codes (N = 1100) and on layer 1 of a (3, 256, 384) stack."""
    g = torch.Generator(device=cuda).manual_seed(3)
    shape = (3, 256, 384) if stacked else (640, 1100)
    wq = _quantize_w(torch.randn(shape, generator=g, device=cuda) * 0.2)
    q, s = (wq["q"][1], wq["scale"][1]) if stacked else (wq["q"], wq["scale"])
    x = torch.randn(77, shape[-2], generator=g, device=cuda).to(dtype)
    xk, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    fn = tqm.w8_matmul_stacked if stacked else tqm.w8_matmul
    before = fn.launches
    y = (tqm.w8_matmul_stacked(xk, wq["q"], wq["scale"], 1) if stacked
         else tqm.w8_matmul(xk, q, s))
    assert fn.launches == before + 1 and y.grad_fn is not None
    ref = tqm.w8_matmul_plain(xr, q, s)
    dy = torch.randn(y.shape, generator=g, device=cuda).to(dtype)
    dx, = torch.autograd.grad(y, xk, dy)
    dref, = torch.autograd.grad(ref, xr, dy)
    torch.cuda.synchronize()
    assert _rel_err(y, ref) < tol and _rel_err(dx, dref) < tol, (
        _rel_err(y, ref), _rel_err(dx, dref))


def _w8_call(fn, *args):
    """One W8 wrapper call: its result and how many of its launches took the
    Hopper kernel."""
    before = (fn.launches, fn.hopper_launches)
    y = fn(*args)
    assert fn.launches == before[0] + 1
    return y, fn.hopper_launches - before[1]


HOPPER_SHAPES = ([(4, 2048, 8192), (8, 8192, 2048), (3968, 2048, 8192)]
                 + [(m, 1024, 4096) for m in (1, 63, 64, 65, 129)])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", HOPPER_SHAPES)
def test_w8_hopper_kernel_matches_plain(cuda, m, k, n):
    """The Hopper kernel (TMA, wgmma, split K reduced in the launch) at the
    decoder's decode and prefill shapes and around its 64-row decode block
    and 256-row prefill block: bf16 within 1e-2 of the largest reference
    value, the path counter moved, two launches bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(m + k)
    wq = _quantize_w(torch.randn(k, n, generator=g, device=cuda) * 0.02)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    y, hopper = _w8_call(tqm.w8_matmul, x, wq["q"], wq["scale"])
    again, _ = _w8_call(tqm.w8_matmul, x, wq["q"], wq["scale"])
    ref = tqm.w8_matmul_plain(x, wq["q"], wq["scale"])
    torch.cuda.synchronize()
    assert hopper == 1
    assert y.dtype == torch.bfloat16 and y.shape == (m, n)
    assert _rel_err(y, ref) < 1e-2, _rel_err(y, ref)
    assert torch.equal(y, again)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 300])
def test_w8_hopper_stacked_layers(cuda, m):
    """Layers 0, 11 and 23 of a (24, 256, 384) stack through the Hopper
    kernel, the index a host int and a device scalar: the same bits, within
    1e-2 of the plain version on that layer's codes."""
    g = torch.Generator(device=cuda).manual_seed(24 + m)
    wq = _quantize_w(torch.randn(24, 256, 384, generator=g, device=cuda) * 0.2)
    x = torch.randn(m, 256, generator=g, device=cuda).bfloat16()
    for li in (0, 11, 23):
        y, hopper = _w8_call(tqm.w8_matmul_stacked, x, wq["q"], wq["scale"], li)
        y2, hopper2 = _w8_call(tqm.w8_matmul_stacked, x, wq["q"], wq["scale"],
                               torch.tensor(li, dtype=torch.int32, device=cuda))
        ref = tqm.w8_matmul_plain(x, wq["q"][li], wq["scale"][li])
        torch.cuda.synchronize()
        assert (hopper, hopper2) == (1, 1)
        assert _rel_err(y, ref) < 1e-2, (li, _rel_err(y, ref))
        assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 300])
def test_w8_hopper_bad_device_layer_gives_nan(cuda, m):
    """A device index outside the stack is not seen on the host: the kernel
    writes NaN (the split-K path at M = 4, one split at M = 300)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    wq = _quantize_w(torch.randn(3, 256, 384, generator=g, device=cuda))
    x = torch.randn(m, 256, generator=g, device=cuda).bfloat16()
    for li in (-1, 3):
        y, hopper = _w8_call(tqm.w8_matmul_stacked, x, wq["q"], wq["scale"],
                             torch.tensor(li, dtype=torch.int32, device=cuda))
        torch.cuda.synchronize()
        assert hopper == 1 and torch.isnan(y).all()


@pytest.mark.cuda
def test_w8_path_counters(cuda):
    """The shape rule picks the kernel and the counters say which ran: the
    vocab head's padded codes take the Hopper kernel; its dense codes (rows
    2-byte aligned), CLIP's K = 588 and an x 2 bytes past a 16-byte boundary
    the mma.sync kernel, fp32 x the CUDA-core kernel; each gives the plain
    version's result."""
    g = torch.Generator(device=cuda).manual_seed(7)
    w = {kn: _quantize_w(torch.randn(*kn, generator=g, device=cuda) * 0.02)
         for kn in ((2048, 32002), (588, 1024), (1024, 1024))}
    dense = dict(w[2048, 32002], q=w[2048, 32002]["q"].contiguous())
    x = {k: torch.randn(4, k, generator=g, device=cuda).bfloat16()
         for k in (2048, 588, 1024)}
    flat = torch.randn(4 * 1024 + 1, generator=g, device=cuda).bfloat16()
    x_off = flat[1:].view(4, 1024)
    assert x_off.is_contiguous() and x_off.data_ptr() % 16 != 0
    cases = [(x[2048], w[2048, 32002], 1), (x[2048], dense, 0),
             (x[588], w[588, 1024], 0),
             (x[1024], w[1024, 1024], 1), (x_off, w[1024, 1024], 0),
             (x[1024].float(), w[1024, 1024], 0)]
    for x, wq, want in cases:
        y, hopper = _w8_call(tqm.w8_matmul, x, wq["q"], wq["scale"])
        ref = tqm.w8_matmul_plain(x, wq["q"], wq["scale"])
        torch.cuda.synchronize()
        assert hopper == want, (tuple(x.shape), wq["q"].shape, x.dtype)
        bar = 1e-5 if x.dtype == torch.float32 else 1e-2
        assert _rel_err(y, ref) < bar


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 8, 300, 3968])
def test_w8_vocab_head_on_padded_codes(cuda, m):
    """(M, 2048) x the (2048, 32002) codes as _quantize_w makes them (rows
    32016 codes apart): the Hopper kernel, counted, within 1e-2 of the
    largest reference value, the last two columns (the last column tile's
    only ones) too, two launches bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(m)
    wq = _quantize_w(torch.randn(2048, 32002, generator=g, device=cuda) * 0.02)
    assert wq["q"].stride() == (32016, 1)
    x = torch.randn(m, 2048, generator=g, device=cuda).bfloat16()
    y, hopper = _w8_call(tqm.w8_matmul, x, wq["q"], wq["scale"])
    again, _ = _w8_call(tqm.w8_matmul, x, wq["q"], wq["scale"])
    ref = tqm.w8_matmul_plain(x, wq["q"], wq["scale"])
    torch.cuda.synchronize()
    assert hopper == 1 and y.shape == (m, 32002)
    assert _rel_err(y, ref) < 1e-2, _rel_err(y, ref)
    tail = (y[:, -2:].float() - ref[:, -2:].float()).abs().max().item()
    assert tail < 1e-2 * ref.float().abs().max().item()
    assert torch.equal(y, again)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 300])
def test_w8_vocab_head_dense_codes_take_mma(cuda, m):
    """Dense (2048, 32002) codes, rows 2-byte aligned, stay on the mma.sync
    kernel and give the plain version's result."""
    g = torch.Generator(device=cuda).manual_seed(m + 1)
    wq = _quantize_w(torch.randn(2048, 32002, generator=g, device=cuda) * 0.02)
    q = wq["q"].contiguous()
    x = torch.randn(m, 2048, generator=g, device=cuda).bfloat16()
    y, hopper = _w8_call(tqm.w8_matmul, x, q, wq["scale"])
    ref = tqm.w8_matmul_plain(x, q, wq["scale"])
    torch.cuda.synchronize()
    assert hopper == 0
    assert _rel_err(y, ref) < 1e-2, _rel_err(y, ref)


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


TILE_CASES = ([(d, g, length) for length in (64, 1024) for g in (1, 4)
               for d in (64, 128)]
              # three programs whose last 128-row block is half past L
              + [(64, 3, 192), (128, 3, 192)])


@pytest.mark.cuda
@pytest.mark.parametrize("d,g,length", TILE_CASES)
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


def _serve_model(cuda, **kw):
    """A 2-layer decoder of head dim 64 (the kernels' one head size) on the
    card, fp32, the decode kernel on."""
    cfg = tcfg.MagnetoConfig(vocab_size=97, embed_dim=128, ffn_dim=256,
                             layers=2, heads=2, dropout=0.0,
                             attention_dropout=0.0, decode_attn_kernel=True,
                             **kw)
    g = torch.Generator(device=cuda).manual_seed(3)
    return KosmosLanguage(cfg, generator=g, device=cuda), cfg


@pytest.mark.cuda
def test_pool_decode_kernel_with_stale_and_readmitted_slots(cuda):
    """The engine's pool on the card: a staggered schedule of 7 requests
    through 3 slots (rows at unrelated kv_len, inactive slots over stale
    contents, slots re-admitted over an older request's K/V). Before every
    step, one decode step's logits through the decode kernel against plain
    attention on copies of the same pool (1e-4, fp32); an inactive slot
    filled with NaN leaves the active rows' logits unchanged; the token
    streams equal a plain-attention engine's."""
    from kosmosx_torch.generate.sampler import _decode_logits
    from kosmosx_torch.serve import ServeConfig, ServeEngine

    model, cfg = _serve_model(cuda)
    plain_cfg = dataclasses.replace(cfg, decode_attn_kernel=False)
    rng = np.random.default_rng(0)
    work = [([int(t) for t in rng.integers(4, 97, int(rng.integers(3, 40)))],
             int(rng.integers(4, 20))) for _ in range(7)]

    def run(c, check):
        eng = ServeEngine(model, c, ServeConfig(max_batch=3, max_prompt_len=48,
                                                max_len=96, async_drain=False),
                          device=cuda)
        hs, pending, checked = [], list(work), 0
        while pending or eng.num_active or eng.pending:
            if pending and len(eng.pending) < 1:
                p, n = pending.pop(0)
                hs.append(eng.submit(p, max_new_tokens=n))
            active = [s is not None for s in eng.slots]
            if check and any(active) and not all(active):
                pool = [{k: t.clone() for k, t in l.items()}
                        for l in eng.caches]
                act = torch.tensor(active, device=cuda)
                tok = torch.where(act, eng.last, 1)[:, None]
                kern = _decode_logits(model, cfg, tok, pool, eng.index)
                ref = _decode_logits(model, plain_cfg, tok,
                                     [{k: t.clone() for k, t in l.items()}
                                      for l in eng.caches], eng.index)
                assert (kern[act] - ref[act]).abs().max().item() < 1e-4
                stale = active.index(False)
                for l in pool:
                    for t in l.values():
                        t[stale] = float("nan")
                nan = _decode_logits(model, cfg, tok, pool, eng.index)
                assert torch.isfinite(nan[act]).all()
                assert (nan[act] - ref[act]).abs().max().item() < 1e-4
                checked += 1
            eng.step()
        eng.run()
        return [h.tokens for h in hs], checked

    before = tdec.decode_attention.launches
    got, checked = run(cfg, True)
    assert checked > 3 and tdec.decode_attention.launches > before
    assert got == run(plain_cfg, False)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_padded_admission_prefill_through_flash(cuda, dtype, bar):
    """A batched admission of 8 rows of 8 lengths, padded to 300 positions
    with segment id -1 past each row's length (rows ending mid-tile): the
    flash prefill's first-token logits against plain attention's (relative
    to their largest value), and in
    fp32 the same greedy first tokens; then a suffix prefill of 260
    positions after a 40-token prefix (a write past index 0) takes no
    flash launch and matches a whole-prompt prefill."""
    from kosmosx_torch.serve import programs

    model, cfg = _serve_model(cuda)
    model = model.to(dtype)
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16"
                              if dtype == torch.bfloat16 else "float32")
    plain_cfg = dataclasses.replace(cfg, use_flash_attention=False)
    g = torch.Generator(device=cuda).manual_seed(4)
    lengths = torch.tensor([300, 299, 257, 256, 200, 130, 64, 7], device=cuda)
    prompt = torch.randint(4, 97, (8, 300), generator=g, device=cuda)
    prompt[torch.arange(300, device=cuda)[None] >= lengths[:, None]] = 1
    scfg = tsamp.SamplingConfig(greedy=True)
    logits = {}
    for name, c in (("flash", cfg), ("plain", plain_cfg)):
        before = tfa.flash_attention.launches
        x = tsamp.dec.forward_embedding(model, c, prompt)[0]
        caches = tsamp.dec.init_cache(c, 8, 320, device=cuda)
        logits[name] = tsamp._prefill(model, c, x, caches, lengths).float()
        assert tfa.flash_attention.launches - before == \
            (c.layers if name == "flash" else 0)
    err = _rel_err(logits["flash"], logits["plain"])
    assert err < bar, err
    if dtype == torch.float32:
        assert torch.equal(logits["flash"].argmax(-1),
                           logits["plain"].argmax(-1))
    # the suffix after a prefix: 40 tokens prefilled, 260 more at index 40
    row = prompt[:1, :300]
    caches = tsamp.dec.init_cache(cfg, 1, 320, device=cuda)
    x = tsamp.dec.forward_embedding(model, cfg, row[:, :40])[0]
    tsamp._prefill(model, cfg, x, caches, torch.tensor([40], device=cuda))
    before = tfa.flash_attention.launches
    first, lp = programs._prefill_suffix(
        model, row[:, 40:], torch.tensor([260], device=cuda), 40, caches,
        None, cfg, scfg)
    assert tfa.flash_attention.launches == before
    whole = logits["plain"][:1]
    assert int(first) == int(whole.argmax(-1)) or dtype == torch.bfloat16
    want = torch.log_softmax(whole, -1)[0, int(first)].item()
    assert abs(float(lp) - want) < (1e-4 if dtype == torch.float32 else 5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_pool_insert_matches_cpu(cuda, kv):
    """Batch-1 and batch-A caches written into pool rows on the card, int8
    codes with their per-slot scales or bf16, equal to the same inserts
    on the CPU."""
    from kosmosx_torch.nn import decoder as tdec_nn
    from kosmosx_torch.serve import programs

    cfg = tcfg.MagnetoConfig(vocab_size=97, embed_dim=128, layers=2, heads=2,
                             compute_dtype="bfloat16",
                             kv_cache_dtype="int8" if kv == "int8" else None)
    g = torch.Generator().manual_seed(5)

    def filled(b):
        caches = tdec_nn.init_cache(cfg, b, 24)
        for c in caches:
            for k, t in c.items():
                t.copy_((torch.randn(t.shape, generator=g) * 40).to(t.dtype))
        return caches

    pool, one, many = filled(4), filled(1), filled(2)
    outs = []
    for dev in ("cpu", cuda):
        p = [{k: t.to(dev) for k, t in c.items()} for c in pool]
        programs._insert_slot(p, [{k: t.to(dev) for k, t in c.items()}
                                  for c in one], 2)
        programs._insert_rows(p, [{k: t.to(dev) for k, t in c.items()}
                                  for c in many],
                              torch.tensor([3, 0], device=dev))
        outs.append(p)
    for c_cpu, c_cuda in zip(*outs):
        for k in c_cpu:
            assert torch.equal(c_cpu[k], c_cuda[k].cpu()), k
    assert torch.equal(outs[0][0]["k"][2], one[0]["k"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [True, False], ids=["int8", "uint8"])
def test_8bit_moment_codes_match_cpu(cuda, signed):
    """Blockwise moment codes and scales made on the card are the CPU's
    (which the CPU tests hold bit-identical to JAX's): 8192 blocks of a
    (2048, 1024) moment, whose absmax / 127 and / 255 a product with the
    reciprocal would miss by an ulp."""
    from kosmosx_torch.train.quant import quantize_blockwise

    g = torch.Generator().manual_seed(6)
    x = torch.randn((2048, 1024), generator=g) * 1e-3
    if not signed:
        x = x.square()
    cpu = quantize_blockwise(x, signed=signed)
    card = quantize_blockwise(x.to(cuda), signed=signed)
    assert cpu["scale"].shape == (8192, 1)
    for key in ("q", "scale"):
        assert torch.equal(card[key].cpu(), cpu[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adamw8bit", "lion8bit"])
def test_8bit_optimizer_step_matches_cpu(cuda, name):
    """One clipped 8-bit step (masked decay, a gradient-free leaf) on the
    card equals the same step on the CPU: codes and scales identical,
    parameters within 1e-6."""
    from kosmosx_torch.train import optim as toptim

    g = torch.Generator().manual_seed(7)
    shapes = {"a.w": (64, 300), "a.b": (300,), "b.w": (17, 9)}
    params = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
    grads = {"a.w": torch.randn(shapes["a.w"], generator=g) * 3,
             "a.b": torch.randn(shapes["a.b"], generator=g), "b.w": None}
    out = []
    for dev in ("cpu", cuda):
        ps = {n: p.clone().to(dev) for n, p in params.items()}
        opt = toptim.make_optimizer(
            name, toptim.make_schedule("constant", 1e-3, 10, 1), ps)
        opt.step({n: None if t is None else t.to(dev) for n, t in grads.items()})
        out.append((ps, opt.state_dict()))
    (p_cpu, s_cpu), (p_card, s_card) = out
    for n in params:
        torch.testing.assert_close(p_card[n].cpu(), p_cpu[n], atol=1e-6,
                                   rtol=1e-6)
        for slot in ("mu", "nu"):
            if n in s_cpu[slot]:
                for key in ("q", "scale"):
                    assert torch.equal(s_card[slot][n][key].cpu(),
                                       s_cpu[slot][n][key]), (slot, n, key)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_dropout_gradients_survive_remat_on_the_card(cuda, policy):
    """Under dropout (0.1 on the residuals, the activations and the
    attention probabilities) a CUDA generator of one seed gives the same
    gradients with remat as without, within 1e-5 of each gradient's largest
    value (flash off: attention dropout takes the plain path)."""
    from kosmosx_torch.train import data as tdata
    from kosmosx_torch.train import trainer as ttrainer

    cfg = tcfg.MagnetoConfig(vocab_size=97, embed_dim=128, ffn_dim=256,
                             layers=2, heads=2, dropout=0.1,
                             attention_dropout=0.1, activation_dropout=0.1,
                             compute_dtype="float32")
    model = KosmosLanguage(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    batch = tdata.to_device(next(tdata.synthetic_text_batches(
        batch_size=2, seq_len=300, vocab_size=97)), cuda)
    grads = []
    for c in (cfg, dataclasses.replace(cfg, remat=True, remat_policy=policy)):
        model.config = c
        _, gr = ttrainer.value_and_grad(
            ttrainer.lm_loss_fn(c), model, batch,
            torch.Generator(device=cuda).manual_seed(11))
        grads.append(gr)
    for n, g0 in grads[0].items():
        if g0 is None:
            assert grads[1][n] is None, n
            continue
        err = (grads[1][n] - g0).abs().max() / g0.abs().max().clamp_min(1e-30)
        assert err <= 1e-5, (n, float(err))


LN_WIDTHS = (1, 100, 768, 1024, 2048, 8192, 16384)
LN_ROWS = (1, 128, 8184)
# (x, scale and bias): fp32; bf16 with bf16 parameters (serving, scoring);
# bf16 with fp32 master parameters (training); fp16 (a float16 config);
# fp32 with bf16 parameters (an fp32 reference of a bf16 model), which the
# kernels read as fp32
LN_DTYPES = {"f32": (torch.float32, torch.float32),
             "bf16": (torch.bfloat16, torch.bfloat16),
             "bf16_f32": (torch.bfloat16, torch.float32),
             "f16": (torch.float16, torch.float16),
             "f32_bf16": (torch.float32, torch.bfloat16)}


def _ln_inputs(dev, rows, width, dtype, w_dtype, seed=0, lead=None):
    """x far from zero mean, the scale near 1, the bias, dy."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = lead or (rows, width)
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 3).to(dtype)
    scale = (torch.randn(width, generator=g, device=dev) * 0.5 + 1
             ).to(w_dtype)
    bias = torch.randn(width, generator=g, device=dev).to(w_dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    return x, scale, bias, dy


def _within_ulp(a, ref):
    """Largest gap in units of one ulp of ``ref``'s dtype (bf16 or fp16) at
    the larger side, counted no finer than at 1/256 of the reference's
    largest value: an output near 0 is a difference of O(1) terms, whose
    fp32 roundings (summed in another order by the plain version) exceed
    its own ulp."""
    bits = {torch.bfloat16: 7, torch.float16: 10}[ref.dtype]
    a, ref = a.float(), ref.float()
    floor = max(ref.abs().max().item() / 256, 2.0 ** -126)
    big = torch.maximum(a.abs(), ref.abs()).clamp_min(floor)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - bits)
    return ((a - ref).abs() / ulp).max().item()


def _ln_launches():
    return tln.layer_norm.launches, tln.layer_norm_bwd.launches


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(LN_DTYPES))
@pytest.mark.parametrize("rows", LN_ROWS)
@pytest.mark.parametrize("width", LN_WIDTHS)
def test_layer_norm_kernels_match_plain(cuda, width, rows, kind):
    """Forward (y, mean, rstd) and backward (dx, dscale, dbias) kernels
    against the plain versions, each call one launch."""
    dtype, w_dtype = LN_DTYPES[kind]
    x, scale, bias, dy = _ln_inputs(cuda, rows, width, dtype, w_dtype,
                                    seed=width + rows)
    before = _ln_launches()
    y, mean, rstd = tln.layer_norm_fwd(x, scale, bias)
    dx, ds, db = tln.layer_norm_bwd(x, scale, mean, rstd, dy, bias=bias)
    assert _ln_launches() == tuple(n + 1 for n in before)
    y_ref = tln.layer_norm_plain(x, scale, bias)
    m_ref, r_ref = tln.layer_norm_stats_plain(x)
    dx_ref, ds_ref, db_ref = tln.layer_norm_bwd_plain(x, scale, mean, rstd,
                                                      dy, bias=bias)
    torch.cuda.synchronize()
    assert _rel_err(mean, m_ref) <= 1e-5 and _rel_err(rstd, r_ref) <= 1e-5
    for name, a, r in (("y", y, y_ref), ("dx", dx, dx_ref),
                       ("dscale", ds, ds_ref), ("dbias", db, db_ref)):
        assert a.dtype == r.dtype and a.shape == r.shape, name
    if dtype == torch.float32:
        for name, a, r in (("y", y, y_ref), ("dx", dx, dx_ref)):
            assert _rel_err(a, r) <= 1e-5, (name, _rel_err(a, r))
    else:
        assert _within_ulp(y, y_ref) <= 1, _within_ulp(y, y_ref)
        assert _rel_err(dx, dx_ref) <= 1e-2, _rel_err(dx, dx_ref)
    for name, a, r in (("dscale", ds, ds_ref), ("dbias", db, db_ref)):
        if w_dtype != torch.float32:
            assert _within_ulp(a, r) <= 1, (name, _within_ulp(a, r))
        else:
            bar = 1e-5 if dtype == torch.float32 else 1e-3
            assert _rel_err(a, r) <= bar, (name, _rel_err(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_layer_norm_non_contiguous_input(cuda, kind):
    """A strided row view (``x[:, 0]``, no copy) and leading dims that do
    not collapse (a transpose, copied) give the plain output and autograd's
    gradients through the plain expression."""
    dtype, w_dtype = LN_DTYPES[kind]
    big, scale, bias, _ = _ln_inputs(cuda, 0, 768, dtype, w_dtype,
                                     lead=(64, 3, 768))
    for x in (big[:, 0], big[:, :2].transpose(0, 1)):
        x = x.detach().requires_grad_()
        leaves = [x, scale.detach().requires_grad_(),
                  bias.detach().requires_grad_()]
        dy = torch.randn(x.shape, device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(4)
                         ).to(dtype)
        y = tln.layer_norm(*leaves)
        got = torch.autograd.grad(y, leaves, dy)
        y_ref = tln.layer_norm_plain(*leaves)
        want = torch.autograd.grad(y_ref, leaves, dy)
        torch.cuda.synchronize()
        bar = 1e-5 if dtype == torch.float32 else 1e-2
        assert _rel_err(y, y_ref) <= bar
        for a, r in zip(got, want):
            assert _rel_err(a, r) <= bar, _rel_err(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_layer_norm_autograd_counts_and_frozen_scale(cuda, bias):
    """Through ``layers.layer_norm`` with gradients: one forward and one
    backward launch a call; a frozen scale gives no dscale; no gradient
    (inference) takes the forward alone, saving no stats."""
    x, scale, b, dy = _ln_inputs(cuda, 256, 2048, torch.bfloat16,
                                 torch.float32)
    params = {"scale": scale, "bias": b} if bias else {"scale": scale}
    x.requires_grad_()
    before = _ln_launches()
    y = tlayers.layer_norm(params, x)
    assert _ln_launches() == (before[0] + 1, before[1])
    (dx,) = torch.autograd.grad(y, (x,), dy)
    assert _ln_launches() == (before[0] + 1, before[1] + 1)
    x_ref = x.detach().requires_grad_()
    (dx_ref,) = torch.autograd.grad(
        tln.layer_norm_plain(x_ref, scale, params.get("bias")), (x_ref,), dy)
    torch.cuda.synchronize()
    assert _rel_err(dx, dx_ref) <= 1e-2
    with torch.no_grad():
        tlayers.layer_norm(params, x)
    assert _ln_launches() == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_layer_norm_autograd_function_matches_autograd(cuda, bias, dtype):
    """``LayerNorm`` (the forward and backward kernels) gives autograd's
    output and gradients through the plain expression, each gradient in
    its leaf's dtype: within 1e-5 in fp32, y within one ulp and the
    gradients within 1e-2 of their largest values in bf16. With the scale
    frozen it returns no gradient for it and the same others."""
    x, scale, b, dy = _ln_inputs(cuda, 0, 96, dtype, torch.float32, seed=11,
                                 lead=(2, 3, 96))
    b = b if bias else None
    for frozen in (False, True):
        leaves = [t.detach().requires_grad_()
                  for t in (x, scale, b) if t is not None]
        if frozen:
            leaves[1].requires_grad_(False)
        args = (leaves[0], leaves[1], leaves[2] if bias else None)
        want_of = [t for t in leaves if t.requires_grad]
        y_ref = tln.layer_norm_plain(*args)
        want = torch.autograd.grad(y_ref, want_of, dy)
        y = tln.LayerNorm.apply(*args, 1e-5)
        got = torch.autograd.grad(y, want_of, dy)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            assert _rel_err(y, y_ref) <= 1e-5
        else:
            assert _within_ulp(y, y_ref) <= 1
        bar = 1e-5 if dtype == torch.float32 else 1e-2
        for a, r in zip(got, want):
            assert a.dtype == r.dtype
            assert _rel_err(a, r) <= bar, (frozen, _rel_err(a, r))


@pytest.mark.cuda
def test_layer_norm_span_carries_the_shape(cuda):
    """With tracing on, a kernel call opens one ``op.layer_norm`` device
    span with its rows, width and element size."""
    from kosmosx_torch.utils import trace

    x, scale, bias, _ = _ln_inputs(cuda, 0, 64, torch.bfloat16,
                                   torch.bfloat16, lead=(3, 5, 64))
    trace.clear()
    with trace.enable():
        tln.layer_norm(x, scale, bias)
    (rec,) = [r for r in trace.records() if r.name == "op.layer_norm"]
    assert (rec.attrs["rows"], rec.attrs["width"], rec.attrs["itemsize"]) \
        == (15, 64, 2)
    assert rec.device_ms is not None and rec.device_ms >= 0
    trace.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2048, 8192])
def test_layer_norm_backward_repeats_bit_for_bit(cuda, width):
    """Two identical backward calls at a training shape give the same bits:
    the parameter gradients are summed in a fixed order."""
    x, scale, bias, dy = _ln_inputs(cuda, 8184, width, torch.bfloat16,
                                    torch.float32, seed=5)
    _, mean, rstd = tln.layer_norm_fwd(x, scale, bias)
    first = tln.layer_norm_bwd(x, scale, mean, rstd, dy, bias=bias)
    second = tln.layer_norm_bwd(x, scale, mean, rstd, dy, bias=bias)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_layer_norm_under_remat_dots(cuda):
    """One bf16 decoder layer (flash on) under remat "dots", which saves
    the products and recomputes every LayerNorm, gives the gradients it
    gives without remat (within the flash tests' bf16 bar, 1e-2 of each
    largest value), and the LayerNorm kernels launch on both."""
    from kosmosx_torch.train import data as tdata
    from kosmosx_torch.train import trainer as ttrainer

    cfg = tcfg.MagnetoConfig(vocab_size=97, embed_dim=256, ffn_dim=1024,
                             layers=1, heads=4, compute_dtype="bfloat16")
    model = KosmosLanguage(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    batch = tdata.to_device(next(tdata.synthetic_text_batches(
        batch_size=2, seq_len=256, vocab_size=97)), cuda)
    grads = []
    for c in (cfg, dataclasses.replace(cfg, remat=True, remat_policy="dots")):
        model.config = c
        before = _ln_launches()
        _, gr = ttrainer.value_and_grad(
            ttrainer.lm_loss_fn(c), model, batch,
            torch.Generator(device=cuda).manual_seed(11))
        fwd, bwd = (a - b for a, b in zip(_ln_launches(), before))
        # attn_ln, inner_ln, final_ln, ffn_ln and the stack's ln, each once
        # more under remat; one backward each
        assert (fwd, bwd) == ((5, 5) if c is cfg else (9, 5)), (fwd, bwd)
        grads.append(gr)
    for n, g0 in grads[0].items():
        if g0 is None:
            assert grads[1][n] is None, n
            continue
        assert _rel_err(grads[1][n], g0) <= 1e-2, (n, _rel_err(grads[1][n], g0))
