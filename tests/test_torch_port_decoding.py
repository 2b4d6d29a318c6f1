"""kosmosx_torch's decoding strategies against the JAX package: per-row
sampling overrides, beam search (text and multimodal) and speculative
decoding.

Weights are carried across with ``from_jax_params``; JAX runs at fp32 with
matmul precision "highest" and ``interpret=True``, the port on the CPU.
Bars: greedy tokens and beams identical, scores 1e-4. Draws from a
generator cannot match JAX's: sampled paths are held to the token set JAX
keeps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.generate import beam as tbeam
from kosmosx_torch.generate import sampler as tsamp
from kosmosx_torch.generate import speculative as tspec
from kosmosx_torch.models.kosmos import Kosmos as TKosmos
from kosmosx_torch.models.language import KosmosLanguage as TLanguage
from kosmosx_torch.utils.jax_params import from_jax_params
from kosmosx_tpu.generate import beam as jbeam
from kosmosx_tpu.generate import sampler as jsamp
from kosmosx_tpu.generate import speculative as jspec
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.nn import decoder as jdec
from tests.test_torch_port_model import dec_cfg, kosmos_cfg

TOL = dict(atol=1e-4, rtol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_filter_rows(logits, temps, ks, ps):
    """The per-row filtering of kosmosx_tpu/generate/sampler.py:59-73, as
    written."""
    x = logits.astype(jnp.float32) / jnp.maximum(temps, 1e-6)[:, None]
    v = x.shape[-1]
    sx = jnp.sort(x, axis=-1)[:, ::-1]
    kth = jnp.take_along_axis(sx, jnp.clip(ks - 1, 0, v - 1)[:, None], axis=-1)
    x = jnp.where((ks[:, None] > 0) & (x < kth), -jnp.inf, x)
    sx2 = jnp.sort(x, axis=-1)[:, ::-1]
    cum = jnp.cumsum(jax.nn.softmax(sx2, axis=-1), axis=-1)
    cidx = jnp.sum(cum < ps[:, None], axis=-1, keepdims=True)
    cutoff = jnp.take_along_axis(sx2, cidx, axis=-1)
    return np.asarray(jnp.where((ps[:, None] < 1.0) & (x < cutoff), -jnp.inf, x))


@pytest.mark.parametrize("vocab", [50, 32002])
def test_per_row_filter_keeps_the_token_set_of_jax(vocab):
    """Rows with top-k off, within and past V, top-p off, 0.9 and a value
    that rounds to 1 in fp32 (JAX's cutoff index reaches V and its
    out-of-bounds gather keeps every id), temperatures 0, 0.7 and 1."""
    rng = np.random.default_rng(vocab)
    logits = rng.standard_normal((6, vocab)).astype(np.float32)
    temps = np.array([1.0, 0.7, 0.0, 1.0, 0.5, 1.0], np.float32)
    ks = np.array([0, 7, 0, vocab + 10, 3, 0], np.int32)
    ps = np.array([1.0, 0.9, 0.99999999, 0.99999999, 1.0, 0.8], np.float32)
    got = tsamp.filter_logits_rows(_t(logits), _t(temps), _t(ks).long(), _t(ps))
    want = _jax_filter_rows(jnp.asarray(logits), jnp.asarray(temps),
                            jnp.asarray(ks), jnp.asarray(ps))
    np.testing.assert_array_equal(torch.isfinite(got).numpy(),
                                  np.isfinite(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[finite], want[finite], rtol=1e-6)


def test_sample_logits_rows():
    """Rows that are on draw from their own kept set (temperature 0:
    argmax); the others follow the static config (greedy here)."""
    rng = np.random.default_rng(3)
    logits = _t(rng.standard_normal((4, 40)).astype(np.float32))
    on = torch.tensor([True, True, False, True])
    temps = torch.tensor([1.0, 0.0, 1.0, 0.8])
    ks = torch.tensor([2, 0, 0, 0])
    ps = torch.tensor([1.0, 1.0, 1.0, 0.5])
    kept = torch.isfinite(tsamp.filter_logits_rows(logits, temps, ks, ps))
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        ids = tsamp.sample_logits(logits, tsamp.SamplingConfig(greedy=True), g,
                                  rows=(on, temps, ks, ps))
        assert bool(kept[[0, 3], ids[[0, 3]]].all())
        assert ids[1] == logits[1].argmax() and ids[2] == logits[2].argmax()


@pytest.fixture(scope="module")
def lm():
    cfg_j, cfg_t = dec_cfg(jcfg), dec_cfg(tcfg)
    params = jdec.init_decoder(jax.random.PRNGKey(21), cfg_j)
    return params, TLanguage(cfg_t, params=from_jax_params(_np_tree(params))), \
        cfg_j, cfg_t


def _gen_lengths(tokens, eos):
    """Generated length of each beam: up to its first EOS, or all."""
    out = np.full(tokens.shape[:2], tokens.shape[2])
    for i, j in np.ndindex(*tokens.shape[:2]):
        hit = np.flatnonzero(tokens[i, j] == eos) if eos is not None else []
        if len(hit):
            out[i, j] = hit[0] + 1
    return out


@pytest.mark.parametrize("case", ["plain", "eos", "ragged_double_scale"])
def test_beam_search_matches_jax(lm, case):
    """Beams, normalised and raw scores and generated lengths (the private
    ``_beam_search_jit`` returns them) of JAX's beam search: ragged prompts,
    an EOS that freezes beams, a length penalty, the double-scale
    embedding."""
    params, model, cfg_j, cfg_t = lm
    toks = np.random.default_rng(4).integers(4, 97, (2, 7)).astype(np.int32)
    lengths = np.array([7, 7], np.int32)
    kw = dict(length_penalty=1.0, eos_id=None, double_scale=False)
    if case == "ragged_double_scale":
        toks[1, 3:] = 1
        lengths = np.array([7, 3], np.int32)
        kw.update(length_penalty=0.6, double_scale=True)
    if case == "eos":
        # the token greedy decoding emits third becomes EOS
        probe = tsamp.generate_text(model, cfg_t, _t(toks).long(),
                                    tsamp.SamplingConfig(max_new_tokens=3,
                                                         greedy=True))
        kw["eos_id"] = int(probe[0, 2])
    with jax.default_matmul_precision("highest"):
        ref = jbeam._beam_search_jit(params, jnp.asarray(toks),
                                     jnp.asarray(lengths), cfg_j, 3, 8, 15,
                                     interpret=True, **kw)
    got = tbeam.beam_search(model, cfg_t, _t(toks).long(), beam_size=3,
                            max_new_tokens=8, prompt_lengths=_t(lengths), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), **TOL)
    np.testing.assert_array_equal(_gen_lengths(got[0].numpy(), kw["eos_id"]),
                                  np.asarray(ref[3]))
    assert bool((got[1][:, :-1] >= got[1][:, 1:]).all())
    if case == "eos":
        eos = kw["eos_id"]
        beams = got[0].numpy().reshape(-1, 8)
        assert any(eos in b for b in beams)
        for b in beams:
            if eos in b:
                assert (b[list(b).index(eos):] == eos).all()


def test_beam_one_is_greedy(lm):
    params, model, cfg_j, cfg_t = lm
    toks = _t(np.random.default_rng(5).integers(4, 97, (2, 6))).long()
    ref = tsamp.generate_text(model, cfg_t, toks,
                              tsamp.SamplingConfig(max_new_tokens=7, greedy=True))
    got, _, _ = tbeam.beam_search(model, cfg_t, toks, beam_size=1,
                                  max_new_tokens=7)
    assert torch.equal(got[:, 0], ref)


def test_beam_search_multimodal_matches_jax():
    cfg_j, cfg_t = kosmos_cfg(jcfg), kosmos_cfg(tcfg)
    params = JKosmos.init(jax.random.PRNGKey(22), cfg_j)
    model = TKosmos(cfg_t, params=from_jax_params(_np_tree(params)))
    rng = np.random.default_rng(22)
    toks = rng.integers(4, 97, (2, 9)).astype(np.int32)
    toks[1, 5:] = 1
    lengths = np.array([9, 5], np.int32)
    images = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jbeam.beam_search_multimodal(
            params, cfg_j, jnp.asarray(toks), jnp.asarray(images),
            beam_size=2, max_new_tokens=5, prompt_lengths=jnp.asarray(lengths))
    got = tbeam.beam_search_multimodal(model, cfg_t, _t(toks).long(),
                                       _t(images), beam_size=2,
                                       max_new_tokens=5,
                                       prompt_lengths=_t(lengths))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), **TOL)
    greedy = tsamp.generate_multimodal(
        model, cfg_t, _t(toks).long(), _t(images),
        tsamp.SamplingConfig(max_new_tokens=5, greedy=True),
        prompt_lengths=_t(lengths))
    one, _, _ = tbeam.beam_search_multimodal(model, cfg_t, _t(toks).long(),
                                             _t(images), beam_size=1,
                                             max_new_tokens=5,
                                             prompt_lengths=_t(lengths))
    assert torch.equal(one[:, 0], greedy)


@pytest.fixture(scope="module")
def spec_models():
    """A 2-layer target and a 1-layer draft of another width."""
    cfg_tj = dec_cfg(jcfg, max_positions=128)
    cfg_dj = dec_cfg(jcfg, max_positions=128, layers=1, embed_dim=16,
                     ffn_dim=32, heads=2)
    pt = jdec.init_decoder(jax.random.PRNGKey(30), cfg_tj)
    pd = jdec.init_decoder(jax.random.PRNGKey(31), cfg_dj)
    cfg_tt = dec_cfg(tcfg, max_positions=128)
    cfg_dt = dec_cfg(tcfg, max_positions=128, layers=1, embed_dim=16,
                     ffn_dim=32, heads=2)
    return ((pt, pd, cfg_tj, cfg_dj),
            (TLanguage(cfg_tt, params=from_jax_params(_np_tree(pt))),
             TLanguage(cfg_dt, params=from_jax_params(_np_tree(pd))),
             cfg_tt, cfg_dt))


@pytest.mark.parametrize("gamma,eos", [(1, False), (3, False), (4, True)])
def test_speculative_greedy_matches_generate_text_and_jax(spec_models, gamma,
                                                          eos):
    (pt, pd, cfg_tj, cfg_dj), (mt, md, cfg_tt, cfg_dt) = spec_models
    toks = np.random.default_rng(gamma).integers(4, 97, (2, 7)).astype(np.int32)
    toks[1, 4:] = 1
    lengths = np.array([7, 4], np.int32)
    base = tsamp.SamplingConfig(max_new_tokens=12, greedy=True)
    if eos:
        probe = tsamp.generate_text(mt, cfg_tt, _t(toks).long(), base,
                                    prompt_lengths=_t(lengths))
        base = dataclasses.replace(base, eos_id=int(probe[0, 5]))
    ref_t = tsamp.generate_text(mt, cfg_tt, _t(toks).long(), base,
                                prompt_lengths=_t(lengths))
    out, stats = tspec.speculative_generate(
        mt, md, cfg_tt, cfg_dt, _t(toks).long(), base, gamma=gamma,
        prompt_lengths=_t(lengths))
    with jax.default_matmul_precision("highest"):
        ref_j, jstats = jspec.speculative_generate(
            pt, pd, cfg_tj, cfg_dj, jnp.asarray(toks),
            jsamp.SamplingConfig(**dataclasses.asdict(base)), gamma=gamma,
            prompt_lengths=jnp.asarray(lengths))
    assert torch.equal(out, ref_t)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_j))
    assert stats == jstats


def test_speculative_rows_finishing_in_different_rounds(spec_models):
    """A draft close to the target (its output projection perturbed):
    rows accept different numbers of proposals and finish in different
    rounds, so a finished row's later rounds would write past the cache;
    the tokens and stats are JAX's (which drops those writes) and
    ``generate_text``'s."""
    (pt, _, cfg_tj, _), (mt, _, cfg_tt, _) = spec_models
    rng = np.random.default_rng(12)
    pd = jax.tree_util.tree_map(np.asarray, pt)
    pd["out_proj"]["w"] = pd["out_proj"]["w"] + 0.05 * rng.standard_normal(
        pd["out_proj"]["w"].shape).astype(np.float32)
    md = TLanguage(cfg_tt, params=from_jax_params(pd))
    toks = rng.integers(4, 97, (4, 8)).astype(np.int32)
    scfg = tsamp.SamplingConfig(max_new_tokens=16, greedy=True)
    out, stats = tspec.speculative_generate(mt, md, cfg_tt, cfg_tt,
                                            _t(toks).long(), scfg, gamma=4)
    with jax.default_matmul_precision("highest"):
        ref_j, jstats = jspec.speculative_generate(
            pt, pd, cfg_tj, cfg_tj, jnp.asarray(toks),
            jsamp.SamplingConfig(**dataclasses.asdict(scfg)), gamma=4)
    assert 0 < stats["accepted"] < stats["proposed"]
    assert torch.equal(out, tsamp.generate_text(mt, cfg_tt, _t(toks).long(),
                                                scfg))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_j))
    assert stats == jstats


def test_speculative_self_draft_accepts_everything(spec_models):
    """Draft == target: every proposal is accepted, so rounds collapse to
    ceil((T - 1) / (gamma + 1))."""
    _, (mt, _, cfg_tt, _) = spec_models
    toks = _t(np.random.default_rng(9).integers(4, 97, (2, 6))).long()
    scfg = tsamp.SamplingConfig(max_new_tokens=13, greedy=True)
    out, stats = tspec.speculative_generate(mt, mt, cfg_tt, cfg_tt, toks, scfg,
                                            gamma=3)
    assert torch.equal(out, tsamp.generate_text(mt, cfg_tt, toks, scfg))
    assert stats["rounds"] == -(-(13 - 1) // 4)
    assert stats["accepted"] == stats["proposed"]


def test_speculative_sampling_self_draft_draws_valid_ids(spec_models):
    _, (mt, _, cfg_tt, _) = spec_models
    toks = _t(np.random.default_rng(10).integers(4, 97, (2, 6))).long()
    out, stats = tspec.speculative_generate(
        mt, mt, cfg_tt, cfg_tt, toks,
        tsamp.SamplingConfig(max_new_tokens=10, temperature=0.8), gamma=2,
        generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 10)
    assert bool(((out >= 0) & (out < cfg_tt.vocab_size)).all())
    # a self-draft accepts with probability min(1, p / p) = 1
    assert stats["accepted"] == stats["proposed"]


@pytest.mark.parametrize("case", ["top_k", "window", "positions"])
def test_speculative_guards(spec_models, case):
    _, (mt, md, cfg_tt, cfg_dt) = spec_models
    toks = torch.full((1, 4), 5)
    scfg = tsamp.SamplingConfig(max_new_tokens=4, greedy=True)
    err, match = NotImplementedError, None
    if case == "top_k":
        scfg, match = tsamp.SamplingConfig(max_new_tokens=4, top_k=5), "top-k"
    elif case == "window":
        cfg_tt, match = dataclasses.replace(cfg_tt, kv_window=16), "rolling"
    else:
        scfg = tsamp.SamplingConfig(max_new_tokens=125, greedy=True)
        err, match = ValueError, "position table"
    with pytest.raises(err, match=match):
        tspec.speculative_generate(mt, md, cfg_tt, cfg_dt, toks, scfg)
