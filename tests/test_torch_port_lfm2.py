"""The LFM2 hybrid decoder of kosmosx_torch (``models/lfm2.py``,
``nn/lfm2.py``, ``ops/short_conv.py``, ``ops/qk_rope.py``,
``ops/grouped_moe.py``, RMSNorm and the flash forward's grouped key/value
heads) against the benchmark's plain float32 reference
(``perfbench/reference/lfm2.py``), on seeded random weights at a small
size that keeps the structure: two dense layers (a conv and an attention
layer), then one period of three conv layers and an attention layer over 8
experts, top-2, 4 query heads on 1 key/value head of 64.

No jax here: the JAX package has no LFM2. The ``cuda`` tests hold each
kernel to its plain version on the card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_port_lfm2.py

Bars: the whole forward within 1e-4 of the reference's largest logit, both
sides in fp32 (they compute the same function in other orders: fused
products with the residual added inside, grouped per-expert products,
the conv's taps summed in the kernel's order), everything else below at
fp32 rounding; on the card, the bf16 kernels within one bf16 ulp of their
plain versions (counted no finer than at 1/256 of the largest value: both
round an fp32 result once, in other orders), fp32 within 1e-5.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from kosmosx_torch.core.config import Lfm2Config
from kosmosx_torch.models.lfm2 import Lfm2
from kosmosx_torch.nn import lfm2 as nn_lfm2
from kosmosx_torch.ops import flash_attention as fa
from kosmosx_torch.ops import grouped_moe as gm
from kosmosx_torch.ops import layer_norm as ln
from kosmosx_torch.ops import qk_rope
from kosmosx_torch.ops import short_conv as sc
from perfbench import weights_lfm2
from perfbench.reference import lfm2 as ref

TYPES = ("conv", "full_attention", "conv", "conv", "conv", "full_attention")
TINY = dict(vocab_size=512, hidden_size=256, intermediate_size=192,
            moe_intermediate_size=64, num_hidden_layers=len(TYPES),
            layer_types=list(TYPES), num_attention_heads=4,
            num_key_value_heads=1, conv_L_cache=3, conv_bias=False,
            norm_eps=1e-5, rope_parameters={"rope_theta": 1000000,
                                            "rope_type": "default"},
            num_dense_layers=2, num_experts=8, num_experts_per_tok=2,
            norm_topk_prob=True, routed_scaling_factor=1,
            use_expert_bias=True, max_position_embeddings=128000,
            tie_embedding=True, compute_dtype="float32")
BATCH, LENGTH = 2, 24


def tiny_config(**kw) -> Lfm2Config:
    """The port's config of ``TINY`` (as the benchmark's driver makes it)."""
    from perfbench.drivers import score_lm

    return score_lm.lfm2_config(dict(TINY, **kw))


@pytest.fixture(scope="module")
def tiny():
    """The tiny weights (fp32, the benchmark's distributions), the model
    over them, a batch of Zipf token ids, the reference's logits."""
    torch.manual_seed(0)
    flat = weights_lfm2.make_weights(TINY, 7, "cpu", torch.float32)
    model = Lfm2(tiny_config(), params=ref.nest(flat))
    gen = torch.Generator().manual_seed(3)
    cdf = weights_lfm2.zipf_cdf(TINY["vocab_size"], 1.1, "cpu")
    tokens = weights_lfm2.zipf_tokens(gen, cdf, (BATCH, LENGTH))
    with torch.no_grad():
        x = ref.hidden(flat, TINY, tokens, ref.Lin())
        want = torch.stack([ref.row_logits(flat, TINY, x[r], ref.Lin())
                            for r in range(BATCH)])
    return flat, model, tokens, want


def test_forward_matches_the_reference(tiny):
    """The whole ``apply`` in fp32 within 1e-4 of the largest reference
    logit (the same function summed in other orders)."""
    _, model, tokens, want = tiny
    with torch.inference_mode():
        got = model.apply(tokens)
    assert got.shape == (BATCH, LENGTH, TINY["vocab_size"])
    err = (got - want).abs().max() / want.abs().max()
    assert err < 1e-4, err


def test_forward_is_causal_and_rows_independent(tiny):
    """A row's logits at t see no later token of the row and nothing of
    the other row."""
    _, model, tokens, _ = tiny
    changed = tokens.clone()
    changed[0, 10:] = (changed[0, 10:] + 1) % TINY["vocab_size"]
    with torch.inference_mode():
        a, b = model.apply(tokens), model.apply(changed)
    assert torch.allclose(a[0, :10], b[0, :10], rtol=0, atol=1e-5)
    assert torch.allclose(a[1], b[1], rtol=0, atol=1e-5)
    assert not torch.allclose(a[0, 10:], b[0, 10:], atol=1e-3)


def test_the_fused_layout_is_the_published_one(tiny):
    """The tree splits as the published projections do: in_proj's columns
    are B, C, x~; qkv's q, k, v; w13's w1, w3 (the reference splits them
    the same way); the expert bias stays fp32."""
    flat, model, _, _ = tiny
    layer = model["layers"][2]
    assert tuple(layer["conv"]["in_proj"]["w"].shape) == (256, 3 * 256)
    assert tuple(model["layers"][1]["attn"]["qkv"]["w"].shape) == \
        (256, (4 + 2) * 64)
    assert tuple(layer["moe"]["w13"].shape) == (8, 256, 2 * 64)
    assert layer["moe"]["expert_bias"].dtype == torch.float32
    assert "ffn" in model["layers"][1] and "moe" not in model["layers"][1]


def test_training_and_generation_raise(tiny):
    _, model, tokens, _ = tiny
    with pytest.raises(NotImplementedError, match="forward pass only"):
        model.set_trainable()
    with pytest.raises(NotImplementedError, match="generation"):
        model.generate(tokens)
    leaf = model["norm"]["scale"]
    leaf.requires_grad_(True)
    try:
        with pytest.raises(NotImplementedError, match="training"):
            model.apply(tokens)
    finally:
        leaf.requires_grad_(False)


def test_config_checks():
    with pytest.raises(ValueError, match="layer types"):
        Lfm2Config(layer_types=("conv", "mamba")).check_supported()
    with pytest.raises(ValueError, match="evenly"):
        Lfm2Config(num_key_value_heads=5).check_supported()
    with pytest.raises(ValueError, match="heads of 64"):
        Lfm2Config(num_attention_heads=16).check_supported()
    for key, value in (("conv_bias", True), ("norm_topk_prob", False),
                       ("num_hidden_layers", 7)):
        with pytest.raises(ValueError, match="the port runs"):
            tiny_config(**{key: value})
    cfg = Lfm2Config()
    cfg.check_supported()
    assert cfg.num_hidden_layers == 40 and cfg.head_dim == 64
    assert cfg.layer_types.count("full_attention") == 10


def _conv_by_hand(bcx, taps, seq_len):
    t, d = bcx.shape[0], bcx.shape[1] // 3
    b, c, x = bcx[:, :d], bcx[:, d:2 * d], bcx[:, 2 * d:]
    bx = b * x
    out = torch.zeros(t, d)
    for i in range(t):
        acc = torch.zeros(d)
        for k in range(3):
            j = i - 2 + k
            if j >= (i // seq_len) * seq_len:
                acc = acc + taps[:, k] * bx[j]
        out[i] = c[i] * acc
    return out


def test_short_conv_matches_the_formula_and_sequence_starts():
    """``short_conv`` against y[t] = C[t] sum_k taps[k] (B x~)[t - 2 + k]
    over two sequences of 7 back to back: the second's first positions see
    nothing of the first."""
    g = torch.Generator().manual_seed(1)
    bcx = torch.randn(14, 3 * 16, generator=g)
    taps = torch.randn(16, 3, generator=g)
    got = sc.short_conv(bcx, taps, 7)
    assert torch.allclose(got, _conv_by_hand(bcx, taps, 7), atol=1e-6)
    apart = torch.cat([sc.short_conv(bcx[:7], taps, 7),
                       sc.short_conv(bcx[7:], taps, 7)])
    assert torch.equal(got, apart)


def test_short_conv_is_causal():
    """The output at t is unchanged when inputs after t change."""
    g = torch.Generator().manual_seed(2)
    bcx = torch.randn(12, 3 * 8, generator=g)
    taps = torch.randn(8, 3, generator=g)
    base = sc.short_conv(bcx, taps, 12)
    later = bcx.clone()
    later[6:] = torch.randn(6, 24, generator=g)
    moved = sc.short_conv(later, taps, 12)
    assert torch.equal(base[:6], moved[:6])
    assert not torch.allclose(base[6:], moved[6:])


def test_short_conv_checks():
    with pytest.raises(ValueError, match="taps"):
        sc.short_conv(torch.zeros(4, 24), torch.zeros(8, 2), 4)
    with pytest.raises(ValueError, match="whole sequences"):
        sc.short_conv(torch.zeros(5, 24), torch.zeros(8, 3), 4)
    with pytest.raises(TypeError):
        sc.short_conv(torch.zeros(4, 24, dtype=torch.float16),
                      torch.zeros(8, 3, dtype=torch.float16), 4)


@pytest.mark.parametrize("width", [64, 2048])
def test_rms_norm_matches_the_reference(width):
    g = torch.Generator().manual_seed(width)
    x = torch.randn(33, width, generator=g) * 3
    w = torch.rand(width, generator=g) + 0.5
    got = ln.rms_norm(x, w, eps=1e-5)
    want = ref.rms_norm(x, w, 1e-5)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    assert ln.rms_norm(x.bfloat16(), w.bfloat16()).dtype == torch.bfloat16
    assert torch.equal(ln.rms_norm(x, w, out_dtype=torch.bfloat16),
                       got.bfloat16())


def _attention_by_hand(q, k, v, group):
    """Causal softmax attention, query head h on key/value head h //
    group."""
    idx = torch.arange(q.shape[1]) // group
    k, v = k[:, idx], v[:, idx]
    s = q @ k.transpose(-1, -2) / 8.0
    n = q.shape[2]
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                      float("-inf"))
    return torch.softmax(s, -1) @ v


def test_gqa_attention_matches_repeated_heads():
    """The flash forward over 2 key/value heads for 8 query heads against
    the same attention on K/V repeated to 8 heads, and against the
    h // 4 mapping written out (h % 2 gives another answer)."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 8, 20, 64, generator=g)
    k = torch.randn(2, 2, 20, 64, generator=g)
    v = torch.randn(2, 2, 20, 64, generator=g)
    got = fa.flash_attention_fwd(q, k, v, causal=True, sm_scale=0.125)[0]
    rep = fa.flash_attention_fwd(q, k.repeat_interleave(4, 1),
                                 v.repeat_interleave(4, 1), causal=True,
                                 sm_scale=0.125)[0]
    assert torch.equal(got, rep)
    assert torch.allclose(got, _attention_by_hand(q, k, v, 4), atol=1e-5)
    wrong = torch.arange(8) % 2
    other = fa.flash_attention_fwd(q, k[:, wrong], v[:, wrong], causal=True,
                                   sm_scale=0.125)[0]
    assert not torch.allclose(got, other, atol=1e-3)


def test_qk_norm_rope_matches_the_reference():
    """The QK-norm/RoPE pass against the reference's per-head RMSNorm and
    rotate-half RoPE, v passed through, each in (B, heads, L, 64)."""
    g = torch.Generator().manual_seed(5)
    qkv = torch.randn(2 * 10, (4 + 2 * 1) * 64, generator=g)
    qs, ks = torch.rand(64, generator=g) + 1, torch.rand(64, generator=g) + 1
    q, k, v = qk_rope.qk_norm_rope(qkv, qs, ks, batch=2, heads=4,
                                   kv_heads=1, theta=1e6)
    x = qkv.view(2, 10, 6, 64).transpose(1, 2)
    want_q = ref.rope(ref.rms_norm(x[:, :4], qs, 1e-5), 1e6)
    want_k = ref.rope(ref.rms_norm(x[:, 4:5], ks, 1e-5), 1e6)
    assert torch.allclose(q, want_q, atol=1e-5)
    assert torch.allclose(k, want_k, atol=1e-5)
    assert torch.equal(v, x[:, 5:6])


def test_router_bias_moves_the_choice_not_the_gates():
    """The expert bias changes which experts a token gets but not the
    gates of the experts it gets; gates sum to 1."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(64, 32, generator=g)
    w = torch.randn(32, 8, generator=g) * 32 ** -0.5
    bias = torch.randn(8, generator=g) * 0.3
    e_b, g_b = gm.router_gates(x, w, bias, 2)
    e_0, g_0 = gm.router_gates(x, w, None, 2)
    assert not torch.equal(e_b, e_0)
    s = torch.sigmoid(x @ w)
    picked = torch.gather(s, 1, e_b)
    assert torch.allclose(g_b, picked / (picked.sum(-1, keepdim=True) + 1e-6))
    same = (e_b == e_0).all(-1)
    assert same.any()
    assert torch.equal(g_b[same], g_0[same])
    assert torch.allclose(g_b.sum(-1), torch.ones(64), atol=1e-5)


def test_dropless_when_every_token_picks_the_same_experts():
    """With the bias forcing every token onto experts 5 and 2, both
    experts take all 32 tokens (no capacity): the layer equals the two
    experts' dense SwiGLU, gated, for every token."""
    g = torch.Generator().manual_seed(7)
    d, fe, e = 32, 16, 8
    x = torch.randn(32, d, generator=g)
    res = torch.randn(32, d, generator=g)
    w = torch.randn(d, e, generator=g) * d ** -0.5
    bias = torch.zeros(e)
    bias[5], bias[2] = 10.0, 9.0
    w13 = torch.randn(e, d, 2 * fe, generator=g) * d ** -0.5
    w2 = torch.randn(e, fe, d, generator=g) * fe ** -0.5
    routing = gm.route(x, w, bias, 2)
    assert routing.counts.tolist() == [0, 0, 32, 0, 0, 32, 0, 0]
    got = gm.combine(res, gm.expert_ffn(routing, w13, w2), routing)
    s = torch.sigmoid(x @ w)[:, [5, 2]]
    gates = s / (s.sum(-1, keepdim=True) + 1e-6)
    want = res.clone()
    for j, ex in enumerate((5, 2)):
        want += gates[:, j:j + 1] * ref.swiglu(x, w13[ex], w2[ex], ref.Lin())
    assert torch.allclose(got, want, atol=1e-5)


def test_moe_layer_matches_the_reference(tiny):
    """One MoE layer of the tiny model (route, permute, grouped experts,
    combine) against the reference's expert loop."""
    flat, model, _, _ = tiny
    g = torch.Generator().manual_seed(8)
    x = torch.randn(40, 256, generator=g)
    res = torch.randn(40, 256, generator=g)
    got = nn_lfm2.moe_ffn(model["layers"][3]["moe"], x, res, tiny_config())
    want = res + ref.moe_ffn(flat, "layers.3.moe", x[None], TINY,
                             ref.Lin())[0]
    assert torch.allclose(got, want, atol=1e-5)


def test_route_permutes_by_expert():
    """The permuted rows are sorted by expert, each copy's ``pos`` points
    at its row, the offsets end each expert's rows."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(30, 16, generator=g)
    w = torch.randn(16, 6, generator=g)
    r = gm.route(x, w, None, 3)
    flat = r.experts.reshape(-1)
    sorted_experts = torch.empty_like(flat)
    sorted_experts[r.pos.long().reshape(-1)] = flat
    assert torch.equal(sorted_experts, flat.sort().values)
    assert torch.equal(r.x[r.pos.long().reshape(-1)],
                       x.repeat_interleave(3, 0))
    assert r.offsets.tolist() == torch.bincount(flat, minlength=6).cumsum(
        0).tolist()


def test_model_from_a_generator():
    """``Lfm2`` built from a seeded generator runs and gives finite
    logits; the same seed gives the same model."""
    cfg = dataclasses.replace(tiny_config(), vocab_size=64)
    a = Lfm2(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    b = Lfm2(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, 64, (1, 8))
    with torch.inference_mode():
        la, lb = a.apply(toks), b.apply(toks)
    assert torch.isfinite(la).all() and torch.equal(la, lb)


def test_cpu_path_launches_nothing(tiny):
    _, model, tokens, _ = tiny
    before = (sc.short_conv.launches, qk_rope.qk_norm_rope.launches,
              ln.rms_norm.launches, gm.combine.launches,
              fa.flash_attention.launches)
    with torch.inference_mode():
        model.apply(tokens[:, :8])
    assert (sc.short_conv.launches, qk_rope.qk_norm_rope.launches,
            ln.rms_norm.launches, gm.combine.launches,
            fa.flash_attention.launches) == before


def test_reference_fp8_control_differs(tiny):
    """The fp8 control (every product's operands in e4m3) moves the
    logits by far more than fp32 rounding."""
    flat, _, tokens, want = tiny
    with torch.no_grad():
        x = ref.hidden(flat, TINY, tokens[:1], ref.Lin("fp8"))
        low = ref.row_logits(flat, TINY, x[0], ref.Lin("fp8"))
    rel = ((low - want[0]).square().mean() / want[0].square().mean()) ** 0.5
    assert rel > 1e-2


def _tiny_cell(traffic=None):
    """The benchmark's LFM2 cell at the tiny sizes, on the CPU."""
    import json
    import pathlib

    from perfbench import harness

    root = pathlib.Path(__file__).resolve().parents[1]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = "lfm2-24b-a2b.score-long-b4"
    work = next(w for w in bench["workloads"] if w["name"] == name)
    limits = json.loads((root / "perfbench" / "limits"
                         / f"{name}.json").read_text())
    tr = traffic or {"driver": "score_lm", "batch": 2, "length": 16,
                     "zipf_s": 1.1, "keep_among": 2, "profile_steps": 1}
    return harness.Cell(root, bench, work, dict(TINY), tr,
                        limits["limits"], limits["control"])


@pytest.mark.parametrize("faults,correct", [
    ({}, True), ({"ignore_bias": True}, False), ({"conv_shift": True}, False)],
    ids=["program", "ignore_bias", "conv_shift"])
def test_score_lm_driver_tiny(faults, correct):
    """The cell's driver on the CPU at the tiny sizes: the program's
    logits pass the cell's limits, two planted faults fail them (the
    third, ``kv_mod``, is no fault with one key/value head)."""
    import time

    from perfbench import harness

    cell = _tiny_cell()
    ctx = harness.Context(cell, 2 ** 31 + 11, 0.2, not faults,
                          torch.device("cpu"), time.perf_counter(), faults)
    line = harness.run_cell(cell, ctx)
    assert line["correct"] is correct, line["compared"]
    assert line["attempted"] >= 1 and set(line["compared"]) == {
        "logit_rel_rms"}
    if not faults:
        assert line["metrics"]["mfu.lfm2"]["value"] > 0


def test_forward_flops_of_the_cell():
    """The model FLOPs of a forward at 4 x 8,192 positions: 163.5 TFLOP,
    the experts 58% of them."""
    import json
    import pathlib

    from perfbench import roofline_lfm2

    root = pathlib.Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "perfbench" / "configs"
                      / "lfm2-24b-a2b.json").read_text())
    total = roofline_lfm2.forward_flops(cfg, 4, 8192)
    experts = 4 * 8192 * 38 * 4 * 6 * 2048 * 1536
    assert abs(total / 163.5e12 - 1) < 0.01, total
    assert 0.57 < experts / total < 0.59


def test_lfm2_readers_on_recorded_spans():
    """The cell's span readers over spans recorded with known device
    times: each share is its bound over that time, the ms readers sum a
    forward's spans, a program without the spans reads None."""
    import pathlib

    from kosmosx_torch.utils import trace
    from perfbench import harness, roofline, roofline_lfm2 as rl
    from perfbench import trace as ptrace
    from perfbench.window import Readings

    root = pathlib.Path(__file__).resolve().parents[1]
    spans = {
        "op.short_conv": dict(rows=32768, width=2048, taps=3, itemsize=2),
        "op.moe_experts": dict(assignments=131072, experts=64, d=2048,
                               ffn=1536, itemsize=2),
        "op.qk_norm_rope": dict(rows=32768, length=8192, heads=32,
                                kv_heads=8, d=64, itemsize=2),
        "op.flash_fwd": dict(b=4, h=32, lq=8192, d=64, lk=8192, causal=True,
                             itemsize=2, kv_heads=8),
        "moe.route": dict(tokens=32768, experts=64, top_k=4),
        "moe.combine": dict(tokens=32768, experts=64, top_k=4)}

    def readings():
        found = trace.records()
        lo = min(s.start for s in found) / 1000 - 1
        hi = max(s.end for s in found) / 1000 + 1
        prof = ptrace.Profile([(lo, hi, "void kx_rms_norm_fwd_kernel<bf16>",
                                frozenset())], {}, [], 1.0)
        return Readings(1.0, 1, 1e12, profile=prof, profile_steps=2)

    def read(name, r):
        return harness.load_module(root, "layer_metrics", name).read(r)

    trace.clear()
    with trace.enable():
        for name, attrs in spans.items():
            with trace.span(name, device=True, **attrs) as sp:
                pass
            sp.device_ms = 2.0
    r = readings()
    conv = roofline.bound_s(rl.short_conv_work(32768, 2048, 3, 2))
    assert read("short_conv_roofline", r) == pytest.approx(100 * conv / 2e-3)
    moe = roofline.bound_s(rl.moe_experts_work(131072, 64, 2048, 1536, 2))
    assert read("moe_experts_roofline", r) == pytest.approx(100 * moe / 2e-3)
    attn = roofline.bound_s(rl.qk_norm_rope_work(32768, 32, 8, 8192, 2)) \
        + roofline.bound_s(rl.flash_fwd_gqa_work(4, 32, 8, 8192, 8192, 64,
                                                 causal=True))
    assert read("attn_roofline", r) == pytest.approx(100 * attn / 4e-3)
    assert read("moe_route_ms", r) == pytest.approx(2.0)
    assert read("rms_norm_ms", r) == pytest.approx((r.profile.kernels[0][1]
                                                    - r.profile.kernels[0][0])
                                                   / 1e3 / 2)
    trace.clear()
    with trace.enable():
        with trace.span("op.flash_fwd", b=1):
            pass
    r = readings()
    for name in ("short_conv_roofline", "moe_experts_roofline",
                 "attn_roofline", "moe_route_ms"):
        assert read(name, r) is None
    trace.clear()


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    """Within one ulp of ``dtype`` (no finer than at 1/256 of the largest
    value) for bf16, 1e-5 of the largest value for fp32."""
    got, want = got.float(), want.float()
    top = want.abs().max().clamp_min(1e-30)
    if dtype == torch.float32:
        return float((got - want).abs().max() / top) <= 1e-5
    floor = top / 256
    ulp = torch.maximum(want.abs(), floor) * 2.0 ** -7
    return bool(((got - want).abs() <= ulp).all())


@pytest.mark.cuda
def test_cuda_short_conv(cuda):
    """The bf16 kernel against the plain version; fp32 is the plain
    version's alone."""
    g = torch.Generator(device=cuda).manual_seed(0)
    bcx = torch.randn(3 * 100, 3 * 2048, generator=g, device=cuda).bfloat16()
    taps = torch.randn(2048, 3, generator=g, device=cuda).bfloat16()
    before = sc.short_conv.launches
    got = sc.short_conv(bcx, taps, 100)
    torch.cuda.synchronize()
    assert sc.short_conv.launches == before + 1
    assert _close(got, sc.short_conv_plain(bcx, taps, 100), torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        sc.short_conv(bcx.float(), taps.float(), 100)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 2048])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)], ids=["fp32", "bf16", "fp32_to_bf16"])
def test_cuda_rms_norm(cuda, dtype, out_dtype, width):
    """The kernel against the plain version, the fp32 residual stream
    normalised into bf16 (the decoder's case) among them."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(1000, width, generator=g, device=cuda) * 3).to(dtype)
    w = (torch.rand(width, generator=g, device=cuda) + 0.5).to(out_dtype)
    before = ln.rms_norm.launches
    got = ln.rms_norm(x, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ln.rms_norm.launches == before + 1 and got.dtype == out_dtype
    assert _close(got, ln.rms_norm_plain(x, w, out_dtype=out_dtype),
                  out_dtype)


@pytest.mark.cuda
def test_cuda_qk_norm_rope(cuda):
    """The bf16 kernel against the plain version; fp32 is the plain
    version's alone."""
    g = torch.Generator(device=cuda).manual_seed(2)
    bf = torch.bfloat16
    qkv = torch.randn(2 * 300, 48 * 64, generator=g, device=cuda).to(bf)
    qs = (torch.rand(64, generator=g, device=cuda) + 1).to(bf)
    ks = (torch.rand(64, generator=g, device=cuda) + 1).to(bf)
    kw = dict(batch=2, heads=32, kv_heads=8, theta=1e6)
    got = qk_rope.qk_norm_rope(qkv, qs, ks, **kw)
    want = qk_rope.qk_norm_rope_plain(qkv, qs, ks, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and _close(a, b, bf)
    assert torch.equal(got[2], want[2])
    with pytest.raises(TypeError, match="bfloat16"):
        qk_rope.qk_norm_rope(qkv.float(), qs, ks, **kw)


@pytest.mark.cuda
def test_cuda_moe_layer(cuda):
    """Routing, the grouped products and the combine kernel on the card
    (bf16 experts into the fp32 stream, the decoder's dtypes) against the
    same layer on the CPU; nothing read by the host."""
    dtype, res_dtype = torch.bfloat16, torch.float32
    g = torch.Generator(device=cuda).manual_seed(3)
    d, fe, e, t = 256, 128, 16, 500
    x = torch.randn(t, d, generator=g, device=cuda).to(dtype)
    res = torch.randn(t, d, generator=g, device=cuda).to(res_dtype)
    w = torch.randn(d, e, generator=g, device=cuda).to(dtype) * d ** -0.5
    bias = torch.randn(e, generator=g, device=cuda) * 0.1
    w13 = (torch.randn(e, d, 2 * fe, generator=g, device=cuda)
           * d ** -0.5).to(dtype)
    w2 = (torch.randn(e, fe, d, generator=g, device=cuda)
          * fe ** -0.5).to(dtype)
    before = gm.combine.launches
    routing = gm.route(x, w, bias, 4)
    got = gm.combine(res, gm.expert_ffn(routing, w13, w2), routing)
    torch.cuda.synchronize()
    assert gm.combine.launches == before + 1
    cpu = [t_.cpu() for t_ in (x, w, bias, w13, w2, res)]
    r_cpu = gm.route(cpu[0], cpu[1], cpu[2], 4)
    assert torch.equal(r_cpu.experts, routing.experts.cpu())
    want = gm.combine_plain(cpu[5], gm.expert_ffn(r_cpu, cpu[3], cpu[4]),
                            r_cpu.pos, r_cpu.gates)
    err = (got.cpu().float() - want.float()).abs().max() \
        / want.float().abs().max()
    assert err < 2e-2, err
    with pytest.raises(TypeError, match="fp32 res"):
        gm.combine(res.bfloat16(), x.new_zeros(t * 4, d), routing)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_gqa(cuda, dtype):
    """The forward over 8 key/value heads for 32 query heads: the same
    bits as the kernel on K/V repeated to 32 heads (Hkv = H), and within
    the flash bars of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(2, 32, 300, 64, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, 8, 300, 64, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, 8, 300, 64, generator=g, device=cuda).to(dtype)
    got = fa.flash_attention_fwd(q, k, v, causal=True, sm_scale=0.125)
    rep = fa.flash_attention_fwd(q, k.repeat_interleave(4, 1).contiguous(),
                                 v.repeat_interleave(4, 1).contiguous(),
                                 causal=True, sm_scale=0.125)
    torch.cuda.synchronize()
    for a, b in zip(got, rep):
        assert torch.equal(a, b)
    want = fa.flash_attention_plain(q, k, v, causal=True, sm_scale=0.125)[0]
    bar = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got[0].float() - want.float()).abs().max() < bar


@pytest.mark.cuda
def test_cuda_lfm2_forward(cuda):
    """The tiny model in bf16 on the card against its fp32 forward on the
    CPU: the kernels in place of every plain path."""
    flat = weights_lfm2.make_weights(TINY, 7, "cpu", torch.float32)
    cpu = Lfm2(tiny_config(), params=ref.nest(flat))
    gpu = Lfm2(tiny_config(compute_dtype="bfloat16"),
               params=ref.nest({k: v.to(cuda) for k, v in flat.items()}))
    tokens = torch.randint(0, TINY["vocab_size"], (BATCH, 64))
    with torch.inference_mode():
        want = cpu.apply(tokens)
        got = gpu.apply(tokens.to(cuda)).float().cpu()
    rel = ((got - want).square().mean() / want.square().mean()) ** 0.5
    assert rel < 2e-2, rel
