"""kosmosx_torch's KV-cache modes against the JAX package: the int8 cache
(``_quantize_kv`` bit-identical), the rolling window (sink slots and a
ring), shared-prefix attention, ``pos_offset``, xPos re-centering, and
rolling-window and int8 generation.

Weights and caches are carried across with ``from_jax_params`` and
``from_jax_caches``; the same numpy inputs go through both packages. JAX
runs at fp32 with matmul precision "highest" and ``interpret=True`` where
it reaches a Pallas kernel; the port runs the plain version of its decode
kernel on the CPU. Bars: 1e-4 at fp32; greedy tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.generate import sampler as tsamp
from kosmosx_torch.models.kosmos import Kosmos as TKosmos
from kosmosx_torch.models.language import KosmosLanguage as TLanguage
from kosmosx_torch.nn import attention as tattn
from kosmosx_torch.nn import decoder as tdec
from kosmosx_torch.nn import xpos as txpos
from kosmosx_torch.utils.jax_params import from_jax_caches, from_jax_params
from kosmosx_tpu.generate import sampler as jsamp
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.nn import attention as jattn
from kosmosx_tpu.nn import decoder as jdec
from kosmosx_tpu.nn import xpos as jxpos
from tests.test_torch_port_model import dec_cfg, kosmos_cfg

TOL = dict(atol=1e-4, rtol=1e-4)
D, H = 32, 4
HD = D // H
# the window tests' decoder: tiny, max_positions 64, so generation runs
# past the learned table as well as the window
WCFG = dict(vocab_size=61, embed_dim=32, ffn_dim=64, layers=2, heads=4,
            max_positions=64, use_flash_attention=False, multiway=False,
            dropout=0.0, attention_dropout=0.0, compute_dtype="float32")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical(dtype):
    """Codes and scales bit for bit, with all-zero rows (scale 1) and codes
    that land on .5 (round half to even)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32) * 3
    x[0, 1, 2] = 0.0
    x[1, 0, 0] = np.arange(16) * 0.5 - 4.0   # amax 4, steps of 63.5/4
    x[1, 0, 1, :4] = [127.0, 0.5, 1.5, -2.5]
    x[1, 0, 1, 4:] = 0.0
    codes_j, scale_j = jattn._quantize_kv(jnp.asarray(x).astype(dtype))
    codes_t, scale_t = tattn._quantize_kv(
        _t(x, getattr(torch, dtype)))
    assert codes_t.dtype == torch.int8 and scale_t.dtype == torch.float32
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(scale_t.numpy().view(np.int32),
                                  np.asarray(scale_j).view(np.int32))


def _attn_params():
    params = jattn.init_self_attention(jax.random.PRNGKey(3), D, H,
                                       multiway=False)
    return params, from_jax_params(_np_tree(params))


def _empty_cache(b, s, int8):
    if int8:
        shape = (b, H, s, HD)
        return {"k": np.zeros(shape, np.int8),
                "k_scale": np.ones(shape[:-1] + (1,), np.float32),
                "v": np.zeros(shape, np.int8),
                "v_scale": np.ones(shape[:-1] + (1,), np.float32)}
    return {"k": np.zeros((b, H, s, HD), np.float32),
            "v": np.zeros((b, H, s, HD), np.float32)}


# (name, cache length, options): a chunk of 4 at index 0, one-token steps
# at ragged indices, and where the cache is not a ring a chunk of 3 midway
MODES = {
    "int8": (24, dict(int8=True)),
    "ring": (8, dict(kv_window=8, kv_sink=2)),
    "ring_int8": (8, dict(kv_window=8, kv_sink=2, int8=True)),
    "shared": (24, dict(shared=True)),
    "pos_offset": (24, dict(pos_offset=True)),
}


def _steps(ring):
    steps = [(4, np.array([0, 0]))]
    idx = np.array([4, 2])
    for t in range(12):
        if t == 5 and not ring:
            steps.append((3, idx.copy()))
            idx = idx + 3
        steps.append((1, idx.copy()))
        idx = idx + 1
    return steps


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "decode_kernel"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cached_attention_matches_jax(mode, kernel):
    """Chunked and one-token cached steps, output by output, and the cache
    after them, against JAX. The ring wraps twice; ``shared`` mixes rows
    that attend a shared prefix with rows that do not."""
    s_len, opts = MODES[mode]
    jp, tp = _attn_params()
    rng = np.random.default_rng(7)
    cache = _empty_cache(2, s_len, opts.get("int8", False))
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    tcache = {k: _t(v) for k, v in cache.items()}
    kw = dict(heads=H, multiway=False, xpos=True, xpos_scale_base=16,
              use_flash=False, kv_window=opts.get("kv_window", 0),
              kv_sink=opts.get("kv_sink", 4), decode_attn_kernel=kernel)
    jx, tx = {}, {}
    if opts.get("shared"):
        prefix = rng.standard_normal((2, 1, H, 5, HD)).astype(np.float32)
        on = np.array([True, False])
        off = np.array([5, 0], np.int32)
        jx = dict(shared_kv={"k": jnp.asarray(prefix[0]),
                             "v": jnp.asarray(prefix[1])},
                  shared_on=jnp.asarray(on), pos_offset=jnp.asarray(off))
        tx = dict(shared_kv={"k": _t(prefix[0]), "v": _t(prefix[1])},
                  shared_on=_t(on), pos_offset=_t(off).long())
    if opts.get("pos_offset"):
        off = np.array([3, 7], np.int32)
        jx, tx = dict(pos_offset=jnp.asarray(off)), dict(pos_offset=_t(off).long())
    for l, idx in _steps(opts.get("kv_window", 0) > 0):
        x = rng.standard_normal((2, l, D)).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            ref, jcache = jattn.self_attention(
                jp, jnp.asarray(x), cache=jcache, cache_index=jnp.asarray(idx),
                interpret=True, **kw, **jx)
        out = tattn.self_attention(tp, _t(x), cache=tcache,
                                   cache_index=_t(idx).long(), **kw, **tx)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"step at {idx.tolist()}, l={l}")
    for key, ref in jcache.items():
        got = tcache[key].numpy()
        if key in ("k", "v") and opts.get("int8"):
            # a code next to a .5 boundary may round either way
            assert np.abs(got.astype(int) - np.asarray(ref).astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_ring_write_positions_and_sinks():
    """Port of tests/test_streaming_window.py::
    test_ring_write_positions_and_sinks: sink slots keep their K/V
    forever; ring slots cycle over [sink, window)."""
    d, h, w, s = 16, 2, 8, 2
    params = from_jax_params(_np_tree(jattn.init_self_attention(
        jax.random.PRNGKey(0), d, h, multiway=False)))
    cache = {"k": torch.zeros(1, h, w, d // h), "v": torch.zeros(1, h, w, d // h)}
    g = torch.Generator().manual_seed(1)
    snapshots = {}
    for t in range(20):
        tattn.self_attention(
            params, torch.randn(1, 1, d, generator=g), heads=h,
            multiway=False, xpos=False, use_flash=False, cache=cache,
            cache_index=torch.tensor([t]), kv_window=w, kv_sink=s)
        snapshots[t] = cache["k"][0, 0].clone()
    assert torch.equal(snapshots[2][:s], snapshots[19][:s])
    slot = s + (19 - s) % (w - s)
    assert not torch.allclose(snapshots[18][slot], snapshots[19][slot])


def test_recenter_scale_and_position_bound_match_jax():
    for sb in (2, 8, 64, 512):
        assert txpos.xpos_position_bound(sb) == jxpos.xpos_position_bound(sb)
    for delta in (12, np.array([0, 5, 4096], np.int32)):
        for hd in (8, 64):
            got = txpos.recenter_scale(hd, torch.as_tensor(delta), 512)
            ref = jxpos.recenter_scale(hd, jnp.asarray(delta), 512)
            assert tuple(got.shape) == ref.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-6)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_recenter_caches_matches_jax(kind):
    """Keys rescaled (int8: dequantised, rescaled, quantized again), values
    untouched; the port's list from ``from_jax_caches`` of JAX's stacked
    cache."""
    cfg_j = dec_cfg(jcfg, xpos_scale_base=64,
                    kv_cache_dtype="int8" if kind == "int8" else None)
    cfg_t = dec_cfg(tcfg, xpos_scale_base=64,
                    kv_cache_dtype="int8" if kind == "int8" else None)
    rng = np.random.default_rng(2)
    shape = (2, 2, 4, 16, 8)  # (layers, B, H, S, hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if kind == "int8":
        (kq, ks), (vq, vs) = (jattn._quantize_kv(jnp.asarray(a)) for a in (k, v))
        stacked = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    else:
        stacked = {"k": jnp.asarray(k, kind), "v": jnp.asarray(v, kind)}
    delta = np.array([7, 300], np.int32)
    ref = jdec.recenter_caches(stacked, jnp.asarray(delta), cfg_j)
    got = tdec.recenter_caches(from_jax_caches(_np_tree(stacked)),
                               torch.as_tensor(delta), cfg_t)
    for li in range(shape[0]):
        for key in stacked:
            a = got[li][key]
            r = np.asarray(ref[key][li])
            if key == "k" and kind == "bfloat16":
                # one bf16 rounding of a product whose fp32 factor may differ
                # in its last bit
                np.testing.assert_allclose(a.float().numpy(), r.astype(np.float32),
                                           rtol=2 ** -8, atol=0)
            elif key == "k" and kind == "int8":
                assert np.abs(a.numpy().astype(int) - r.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(a.float().numpy(),
                                           r.astype(np.float32), **TOL)


def test_from_jax_caches_layouts():
    """List and stacked layouts, bf16 and int8 with scales."""
    cfg = dec_cfg(jcfg, kv_cache_dtype="int8")
    for layout in (jdec.init_cache(cfg, 2, 8),
                   jdec.init_cache(dataclasses.replace(cfg, scan_layers=True),
                                   2, 8),
                   jdec.init_cache(dec_cfg(jcfg, compute_dtype="bfloat16"),
                                   2, 8)):
        got = from_jax_caches(_np_tree(layout))
        ref = tdec.init_cache(dec_cfg(tcfg, kv_cache_dtype=(
            "int8" if "k_scale" in got[0] else None),
            compute_dtype=("bfloat16" if got[0]["k"].dtype == torch.bfloat16
                           else "float32")), 2, 8)
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            assert sorted(g) == sorted(r)
            for key in g:
                assert g[key].dtype == r[key].dtype
                assert torch.equal(g[key], r[key]), key


def test_recentered_step_matches_fixed_center():
    """One ring decode step with the cache re-centered and ``xpos_center``
    moved by the same delta gives the output of the original cache at
    center 0 (the center cancels in q.k)."""
    params = from_jax_params(_np_tree(jattn.init_self_attention(
        jax.random.PRNGKey(0), 16, 2, multiway=False)))
    kw = dict(heads=2, multiway=False, xpos=True, xpos_scale_base=64,
              use_flash=False, kv_window=16, kv_sink=2)
    cache = {"k": torch.zeros(1, 2, 16, 8), "v": torch.zeros(1, 2, 16, 8)}
    g = torch.Generator().manual_seed(1)
    for t in range(12):
        tattn.self_attention(params, torch.randn(1, 1, 16, generator=g),
                             cache=cache, cache_index=torch.tensor([t]), **kw)
    xq = torch.randn(1, 1, 16, generator=g)
    step = torch.tensor([12])
    ref = tattn.self_attention(
        params, xq, cache={k: v.clone() for k, v in cache.items()},
        cache_index=step, **kw)
    cfg = tcfg.MagnetoConfig(embed_dim=16, heads=2, layers=1,
                             xpos_scale_base=64)
    moved = tdec.recenter_caches([cache], step, cfg)[0]
    got = tattn.self_attention(params, xq, cache=moved, cache_index=step,
                               xpos_center=step, **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module")
def window_params():
    params = jdec.init_decoder(jax.random.PRNGKey(0), jcfg.MagnetoConfig(**WCFG))
    return params, TLanguage(tcfg.MagnetoConfig(**WCFG),
                             params=from_jax_params(_np_tree(params)))


def _both_generate(window_params, prompt, lengths, new, **cfg_kw):
    jp, tp = window_params
    cfg_j = jcfg.MagnetoConfig(**WCFG, **cfg_kw)
    cfg_t = tcfg.MagnetoConfig(**WCFG, **cfg_kw)
    with jax.default_matmul_precision("highest"):
        ref = jsamp.generate_text(
            jp, cfg_j, jnp.asarray(prompt),
            jsamp.SamplingConfig(max_new_tokens=new, greedy=True),
            prompt_lengths=jnp.asarray(lengths), interpret=True)
    out = tsamp.generate_text(
        tp, cfg_t, _t(prompt).long(),
        tsamp.SamplingConfig(max_new_tokens=new, greedy=True),
        prompt_lengths=_t(lengths))
    return out.numpy(), np.asarray(ref)


def test_window_unwrapped_matches_full_cache(window_params):
    """A window the generation never fills gives the full cache's tokens,
    and JAX's."""
    prompt = np.array([[5, 9, 2, 33, 7], [8, 4, 1, 1, 1]], np.int32)
    lengths = np.array([5, 2], np.int32)
    full, _ = _both_generate(window_params, prompt, lengths, 10)
    rolled, ref = _both_generate(window_params, prompt, lengths, 10,
                                 kv_window=32, kv_sink=4)
    np.testing.assert_array_equal(rolled, full)
    np.testing.assert_array_equal(rolled, ref)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "decode_kernel"])
def test_window_past_table_and_window_matches_jax(window_params, kernel):
    """190 tokens past a 16-slot window and the 64-row table, ragged
    prompts, xpos_scale_base 4 so that the keys are re-centered every 32
    steps: JAX's tokens."""
    prompt = np.array([[5, 9, 2, 17, 40], [3, 8, 1, 1, 1]], np.int32)
    lengths = np.array([5, 2], np.int32)
    out, ref = _both_generate(window_params, prompt, lengths, 190,
                              kv_window=16, kv_sink=2, xpos_scale_base=4,
                              decode_attn_kernel=kernel)
    assert out.shape == (2, 190)
    np.testing.assert_array_equal(out, ref)
    assert len(set(out[0, -64:].tolist())) > 1


@pytest.mark.parametrize("case,cfg_kw,prompt_len,match", [
    ("sink", dict(kv_window=4, kv_sink=4), 2, "kv_sink"),
    ("prompt_past_window", dict(kv_window=8, kv_sink=2), 12, "kv_window"),
    ("prompt_past_table", dict(kv_window=80, kv_sink=2), 70,
     "learned position table"),
    ("reach", dict(kv_window=130, kv_sink=4, xpos_scale_base=2), 2,
     "re-center interval")])
def test_window_guards_match_jax(window_params, case, cfg_kw, prompt_len,
                                 match):
    """The four guards of rolling-window generation raise in both packages
    with the same message."""
    jp, tp = window_params
    prompt = np.full((1, prompt_len), 5, np.int32)
    with pytest.raises(ValueError, match=match) as ej:
        jsamp.generate_text(jp, jcfg.MagnetoConfig(**WCFG, **cfg_kw),
                            jnp.asarray(prompt),
                            jsamp.SamplingConfig(max_new_tokens=4))
    with pytest.raises(ValueError, match=match) as et:
        tsamp.generate_text(tp, tcfg.MagnetoConfig(**WCFG, **cfg_kw),
                            _t(prompt).long(),
                            tsamp.SamplingConfig(max_new_tokens=4))
    assert str(et.value) == str(ej.value)


def test_multimodal_window_raises():
    cfg = kosmos_cfg(tcfg, kv_window=16)
    with pytest.raises(NotImplementedError, match="rolling KV window"):
        tsamp.generate_multimodal(None, cfg, torch.zeros(1, 4).long(),
                                  torch.zeros(1, 3, 28, 28))


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "decode_kernel"])
def test_generate_text_int8_cache_matches_jax(kernel):
    cfg_j = dec_cfg(jcfg, kv_cache_dtype="int8", decode_attn_kernel=kernel)
    cfg_t = dec_cfg(tcfg, kv_cache_dtype="int8", decode_attn_kernel=kernel)
    params = jdec.init_decoder(jax.random.PRNGKey(11), cfg_j)
    model = TLanguage(cfg_t, params=from_jax_params(_np_tree(params)))
    toks = np.random.default_rng(11).integers(4, 97, (2, 9)).astype(np.int32)
    toks[1, 4:] = 1
    lengths = np.array([9, 4], np.int32)
    with jax.default_matmul_precision("highest"):
        ref = jsamp.generate_text(
            params, cfg_j, jnp.asarray(toks),
            jsamp.SamplingConfig(max_new_tokens=8, greedy=True),
            prompt_lengths=jnp.asarray(lengths), interpret=True)
    out = tsamp.generate_text(
        model, cfg_t, _t(toks).long(),
        tsamp.SamplingConfig(max_new_tokens=8, greedy=True),
        prompt_lengths=_t(lengths))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_generate_multimodal_int8_cache_matches_jax():
    cfg_j = kosmos_cfg(jcfg, kv_cache_dtype="int8", decode_attn_kernel=True)
    cfg_t = kosmos_cfg(tcfg, kv_cache_dtype="int8", decode_attn_kernel=True)
    params = JKosmos.init(jax.random.PRNGKey(10), cfg_j)
    model = TKosmos(cfg_t, params=from_jax_params(_np_tree(params)))
    rng = np.random.default_rng(10)
    toks = rng.integers(4, 97, (2, 10)).astype(np.int32)
    toks[1, 6:] = 1
    lengths = np.array([10, 6], np.int32)
    images = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jsamp.generate_multimodal(
            params, cfg_j, jnp.asarray(toks), jnp.asarray(images),
            jsamp.SamplingConfig(max_new_tokens=6, greedy=True),
            prompt_lengths=jnp.asarray(lengths), interpret=True)
    out = tsamp.generate_multimodal(
        model, cfg_t, _t(toks).long(), _t(images),
        tsamp.SamplingConfig(max_new_tokens=6, greedy=True),
        prompt_lengths=_t(lengths))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_shared_prefix_decode_equals_the_prefix_in_the_cache():
    """``_decode_logits`` with ``shared = (shared_caches, shared_on,
    pos_offset)``: a row that attends a 5-token prefix held once at batch 1
    gives the logits of a row whose own cache holds the prefix, for a chunk
    of 4 and a one-token step after it; a row with ``shared_on`` False
    gives those of the chunk alone."""
    cfg_j, cfg = dec_cfg(jcfg), dec_cfg(tcfg)
    model = TLanguage(cfg, params=from_jax_params(_np_tree(
        jdec.init_decoder(jax.random.PRNGKey(12), cfg_j))))
    rng = np.random.default_rng(12)
    prefix = _t(rng.integers(4, 97, (1, 5))).long()
    rest = _t(rng.integers(4, 97, (2, 4))).long()
    nxt = _t(rng.integers(4, 97, (2, 1))).long()
    with torch.inference_mode():
        shared = tdec.init_cache(cfg, 1, 5)
        tsamp._decode_logits(model, cfg, prefix, shared, torch.zeros(1).long())
        own = tdec.init_cache(cfg, 2, 8)
        spec = (shared, torch.tensor([True, False]), torch.tensor([5, 0]))
        got = [tsamp._decode_logits(model, cfg, rest, own, torch.zeros(2).long(),
                                    shared=spec),
               tsamp._decode_logits(model, cfg, nxt, own, torch.full((2,), 4),
                                    shared=spec)]
        full = tdec.init_cache(cfg, 1, 10)
        ref_on = [tsamp._decode_logits(model, cfg, torch.cat([prefix, rest[:1]], 1),
                                       full, torch.zeros(1).long())[:, 5:],
                  tsamp._decode_logits(model, cfg, nxt[:1], full,
                                       torch.full((1,), 9))]
        alone = tdec.init_cache(cfg, 1, 5)
        ref_off = [tsamp._decode_logits(model, cfg, rest[1:], alone,
                                        torch.zeros(1).long()),
                   tsamp._decode_logits(model, cfg, nxt[1:], alone,
                                        torch.full((1,), 4))]
    for g, on, off in zip(got, ref_on, ref_off):
        np.testing.assert_allclose(g[:1].numpy(), on.numpy(), **TOL)
        np.testing.assert_allclose(g[1:].numpy(), off.numpy(), **TOL)
