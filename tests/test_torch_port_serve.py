"""kosmosx_torch's serving engine against the JAX engine, on the CPU.

The tiny decoder of tests/test_serve.py (2 layers, d 64, 4 heads, vocab 97,
fp32) is carried across with ``from_jax_params``. The JAX engine serves a
staggered workload once per module (plain, synchronous drains); greedy
tokens do not depend on the schedule, so every port setting (lags, drain
batches, async drains, decode blocks, batched and chunked admission) must
give the JAX engine's tokens exactly and its log-probs within 1e-4. Int8
and rolling-window pools and a tiny multimodal engine each get a JAX run of
their own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_torch.serve.config as tsc
import kosmosx_tpu.core.config as jcfg
import kosmosx_tpu.serve.config as jsc
from kosmosx_torch.core.params import to_tree
from kosmosx_torch.generate.sampler import SamplingConfig as TSampling
from kosmosx_torch.models.kosmos import Kosmos as TKosmos
from kosmosx_torch.models.language import KosmosLanguage as TLanguage
from kosmosx_torch.serve import ServeConfig as TServeConfig
from kosmosx_torch.serve import ServeEngine as TEngine
from kosmosx_torch.utils.jax_params import from_jax_params
from kosmosx_tpu.generate import SamplingConfig as JSampling
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.nn import decoder as jdec
from kosmosx_tpu.serve import ServeConfig as JServeConfig
from kosmosx_tpu.serve import ServeEngine as JEngine

LP_TOL = 1e-4
CFG_KW = dict(vocab_size=97, embed_dim=64, ffn_dim=128, layers=2, heads=4,
              max_positions=128, use_flash_attention=False, multiway=False,
              dropout=0.0, attention_dropout=0.0, scan_layers=True,
              compute_dtype="float32")
JCFG = jcfg.MagnetoConfig(**CFG_KW)
TCFG = tcfg.MagnetoConfig(**CFG_KW)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(jparams, cfg=TCFG):
    return TLanguage(cfg, params=from_jax_params(_np_tree(jparams), "cpu"))


def workload(n=7, seed=5):
    """(prompt, budget, submit step) triples: ragged prompts of 2-14
    tokens, budgets of 3-9 tokens, arrivals over the first steps."""
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(4, 97, int(rng.integers(2, 15)))],
             int(rng.integers(3, 10)), int(rng.integers(0, 4)))
            for _ in range(n)]


WORK = workload()


def serve(eng, work=WORK, eos=None):
    """Submit ``work`` at its arrival steps while stepping the engine;
    returns the handles in submission order."""
    handles, i, guard = [], 0, 0
    alive = True
    while i < len(work) or alive:
        guard += 1
        assert guard < 500, "engine failed to drain"
        while i < len(work) and work[i][2] <= guard:
            prompt, budget, _ = work[i]
            handles.append(eng.submit(prompt, max_new_tokens=budget,
                                      eos_id=None if eos is None else eos[i]))
            i += 1
        alive = eng.step()
    eng.run()
    return handles


def outputs(handles):
    return [(list(map(int, h.tokens)), list(map(float, h.logprobs)))
            for h in handles]


def assert_same(got, want):
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(gl, wl, atol=LP_TOL, rtol=0)


@pytest.fixture(scope="module")
def jparams():
    return jdec.init_decoder(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tmodel(jparams):
    return port_model(jparams)


@pytest.fixture(scope="module")
def jref(jparams):
    """The JAX engine's tokens and log-probs on ``WORK``."""
    eng = JEngine(jparams, JCFG,
                  JServeConfig(max_batch=3, max_prompt_len=16, max_len=96,
                               async_drain=False),
                  JSampling(greedy=True))
    return outputs(serve(eng))


def port_engine(model, cfg=TCFG, sampling=None, **scfg):
    kw = dict(max_batch=3, max_prompt_len=16, max_len=96)
    kw.update(scfg)
    return TEngine(model, cfg, TServeConfig(**kw),
                   sampling or TSampling(greedy=True), device="cpu")


# the settings tests/test_serve.py pins: sync lags, drain batches with and
# without the async reader, decode blocks, batched-admission pool sizes
SETTINGS = [
    dict(async_drain=False),
    dict(),
    dict(sync_lag=1), dict(sync_lag=3),
    dict(decode_block=2), dict(decode_block=4), dict(decode_block=3, sync_lag=2),
    dict(drain_batch=4, async_drain=False),
    dict(drain_batch=4, sync_lag=4, async_drain=False),
    dict(drain_batch=2, sync_lag=4, async_drain=False),
    dict(drain_batch=8, sync_lag=2, async_drain=False),
    dict(drain_batch=4, sync_lag=4, decode_block=2, async_drain=False),
    dict(drain_batch=1, sync_lag=4, async_drain=True),
    dict(drain_batch=4, sync_lag=2, async_drain=True),
    dict(drain_batch=2, sync_lag=4, decode_block=3, async_drain=True),
    dict(drain_batch=8, async_drain=True),
    dict(max_batch=4), dict(max_batch=8, sync_lag=2), dict(max_batch=8),
    dict(max_batch=3, sync_lag=1),
    dict(prefill_chunk=4), dict(prefill_chunk=5, sync_lag=2),
    dict(prefill_chunk=16),
]


@pytest.mark.parametrize("setting", SETTINGS,
                         ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items())
                         or "default")
def test_engine_matches_jax_engine(tmodel, jref, setting):
    """Greedy tokens identical to the JAX engine's and log-probs within
    1e-4, for every lag, drain, block, batching and chunking setting."""
    assert_same(outputs(serve(port_engine(tmodel, **setting))), jref)


def test_batched_admission_takes_one_prefill(jparams, tmodel):
    """Eight requests into eight free slots admit as one prefill of eight
    rows of 16 positions (the prompts' tokens and the rest padding), and
    give the JAX engine's outputs."""
    work = [(p, b, 0) for p, b, _ in workload(8, seed=9)]
    eng = port_engine(tmodel, max_batch=8, max_len=64)
    got = outputs(serve(eng, work))
    real = sum(len(p) for p, _, _ in work)
    assert (eng.prefills, eng.prefill_positions, eng.prefill_padded) == \
        (1, 8 * 16, 8 * 16 - real)
    jeng = JEngine(jparams, JCFG,
                   JServeConfig(max_batch=8, max_prompt_len=16, max_len=64),
                   JSampling(greedy=True))
    assert_same(got, outputs(serve(jeng, work)))


@pytest.mark.parametrize("setting", [dict(async_drain=False),
                                     dict(sync_lag=2, decode_block=3),
                                     dict(sync_lag=2, drain_batch=2)])
def test_eos_stops_at_the_token(tmodel, jref, setting):
    """An EOS id taken from the JAX stream: each request stops at its first
    occurrence, overrun tokens discarded, every slot freed."""
    eos = [toks[min(2, len(toks) - 1)] for toks, _ in jref]
    eng = port_engine(tmodel, **setting)
    got = serve(eng, eos=eos)
    for h, (toks, _), e in zip(got, jref, eos):
        assert h.done
        assert h.tokens == toks[:toks.index(e) + 1]
    assert eng.slots == [None] * 3 and not eng._inflight


def test_budget_clamp_dispatches_the_budget(tmodel):
    """With the host lagging 4 steps, a slot stops dispatching at its
    budget: exactly ``max_new_tokens`` tokens dispatched per request."""
    eng = port_engine(tmodel, max_batch=2, sync_lag=4, async_drain=False)
    h = [eng.submit([5, 6, 7], max_new_tokens=5),
         eng.submit([8, 9], max_new_tokens=3)]
    steps = eng.run()
    assert [len(x.tokens) for x in h] == [5, 3]
    assert eng._dispatched == [5, 3]
    assert eng.steps == 4          # the longer budget's decode steps
    assert steps > eng.steps       # drain-only steps at the end


def test_cancel_frees_the_slot(tmodel, jref):
    """cancel() frees a slot mid-flight and drops a queued request; the
    others finish with their JAX tokens and the freed slot serves anew."""
    work = [(p, 9, 0) for p, _, _ in WORK[:3]]
    eng = port_engine(tmodel, max_batch=2, async_drain=False)
    h = [eng.submit(p, max_new_tokens=b) for p, b, _ in work]
    for _ in range(3):
        eng.step()
    n0 = len(h[0].tokens)
    assert eng.cancel(h[0]) and eng.cancel(h[2]) and not eng.cancel(h[0])
    eng.run()
    assert len(h[0].tokens) <= n0 + 1 and h[2].tokens == []
    ref = outputs(serve(port_engine(tmodel, async_drain=False), work))
    assert h[1].tokens == ref[1][0]
    h3 = eng.submit(work[0][0], max_new_tokens=9)
    eng.run()
    assert h3.tokens == ref[0][0]


def test_chunked_prefill_interleaves(tmodel):
    """A long prompt streams in two tokens a step while the decoding slot
    emits one token every step.

    Built with ``async_drain=False``: the async reader bookkeeps tokens on
    its own schedule, so after a ``step()`` the host's count could lag the
    device by a variable number of steps and the count below would depend
    on timing. Synchronous drains make it exact."""
    eng = port_engine(tmodel, max_batch=2, max_len=48, prefill_chunk=2,
                      async_drain=False)
    short = eng.submit(WORK[0][0][:3], max_new_tokens=10)
    eng.step()
    eng.step()
    before = len(short.tokens)
    long_req = eng.submit(list(WORK[1][0]) * 2, max_new_tokens=4)
    for _ in range(3):
        eng.step()
    assert len(short.tokens) == before + 3
    assert not long_req.done
    eng.run()
    assert short.done and long_req.done


def test_rejects_oversize_and_bad_sampling(tmodel):
    eng = port_engine(tmodel, max_batch=1, max_prompt_len=8, max_len=16)
    with pytest.raises(ValueError):
        eng.submit(list(range(4, 14)))
    with pytest.raises(ValueError):
        eng.submit([5, 6], max_new_tokens=32)
    with pytest.raises(ValueError):
        eng.submit([])
    with pytest.raises(ValueError, match="temperature"):
        eng.submit([5, 6], temperature=-1.0)
    with pytest.raises(ValueError, match="top_p"):
        eng.submit([5, 6], top_p=0.0)
    with pytest.raises(ValueError, match="top_k"):
        eng.submit([5, 6], top_k=-1)


def test_engine_defaults_to_the_card(tmodel):
    """device=None is the card: CPU parameters then raise, as does a
    generator on another device than the engine's; a mesh takes a
    parameter-tree module (tests/test_torch_port_expert.py serves over
    one)."""
    with pytest.raises(ValueError, match="lie on cpu"):
        TEngine(tmodel, TCFG, TServeConfig(max_batch=2))
    with pytest.raises(ValueError, match="parameter-tree module"):
        TEngine(to_tree(tmodel), TCFG, device="cpu", mesh=object())


def test_per_request_sampling_rows(tmodel, jref):
    """temperature=0 and top_k=1 requests stay greedy beside a hot one."""
    eng = port_engine(tmodel)
    h0 = eng.submit(WORK[0][0], max_new_tokens=WORK[0][1], temperature=0.0)
    h1 = eng.submit(WORK[1][0], max_new_tokens=WORK[1][1], temperature=3.0,
                    top_k=1)
    hot = eng.submit(WORK[2][0], max_new_tokens=8, temperature=5.0)
    eng.run()
    assert h0.tokens == jref[0][0] and h1.tokens == jref[1][0]
    assert len(hot.tokens) == 8


def test_warmup_then_clean_outputs(tmodel, jref):
    """warmup() runs every admission path, resets the counters and leaves
    outputs unchanged; reset_counters() zeroes the anatomy in place."""
    eng = port_engine(tmodel, max_batch=2, prompt_buckets=(4, 8))
    eng.register_prefix([5, 11, 23])
    n = eng.warmup()
    assert n >= 3 and eng.steps == 0 and eng.emitted_total == 0
    assert eng.prefix_hits == 0
    assert_same(outputs(serve(eng)), jref)
    phase = eng.phase_s
    assert phase["dispatch"] > 0
    eng.reset_counters()
    assert eng.phase_s is phase and not any(phase.values())
    assert eng.prefills == eng.prefill_positions == eng.prefill_padded == 0
    eng.submit([5, 6], max_new_tokens=4)
    with pytest.raises(ValueError, match="idle"):
        eng.warmup()
    eng.run()


@pytest.mark.parametrize("setting", [dict(), dict(decode_block=3, sync_lag=1),
                                     dict(prefill_chunk=4)])
def test_int8_pool_matches_jax(jparams, setting):
    """An int8 KV pool: the JAX int8 engine's tokens and log-probs."""
    jc = dataclasses.replace(JCFG, kv_cache_dtype="int8")
    tc = dataclasses.replace(TCFG, kv_cache_dtype="int8")
    ref = _jax_run(jparams, jc, "int8")
    eng = port_engine(port_model(jparams, tc), tc, **setting)
    assert eng.caches[0]["k"].dtype == torch.int8
    assert_same(outputs(serve(eng)), ref)


_JAX_RUNS = {}


def _jax_run(jparams, cfg, key, **scfg):
    if key not in _JAX_RUNS:
        kw = dict(max_batch=3, max_prompt_len=16, max_len=96,
                  async_drain=False)
        kw.update(scfg)
        eng = JEngine(jparams, cfg, JServeConfig(**kw), JSampling(greedy=True))
        _JAX_RUNS[key] = outputs(serve(eng, WINDOW_WORK
                                       if key.startswith("window") else WORK))
    return _JAX_RUNS[key]


WINDOW_KW = dict(kv_window=16, kv_sink=2, xpos_scale_base=4)
WINDOW_WORK = [(p[:12], 40 + 3 * i, i) for i, (p, _, _) in enumerate(WORK[:4])]


@pytest.mark.parametrize("setting", [dict(), dict(decode_block=3),
                                     dict(kv_cache_dtype="int8")])
def test_window_pool_recenters_like_jax(jparams, setting):
    """A 16-slot ring with sinks and xPos re-centered every 32 positions,
    requests running 40-49 tokens past it: the JAX engine's tokens."""
    setting = dict(setting)
    kv8 = setting.pop("kv_cache_dtype", None)
    jc = dataclasses.replace(JCFG, kv_cache_dtype=kv8, **WINDOW_KW)
    tc = dataclasses.replace(TCFG, kv_cache_dtype=kv8, **WINDOW_KW)
    ref = _jax_run(jparams, jc, "window" if kv8 is None else "window8",
                   max_len=64)
    eng = port_engine(port_model(jparams, tc), tc, max_len=64, **setting)
    got = outputs(serve(eng, WINDOW_WORK))
    assert eng.cache_len == 16 and max(eng._center_host) >= 32
    assert_same(got, ref)


def _tiny_kcfg(mod):
    return mod.KosmosConfig(
        decoder=mod.MagnetoConfig(**dict(CFG_KW, vocab_size=128)),
        vision=mod.VisionConfig(image_size=28, patch_size=14, layers=1,
                                hidden_dim=32, heads=2, mlp_dim=64,
                                use_flash_attention=False),
        resampler=mod.ResamplerConfig(dim=32, depth=1, dim_head=8, heads=2,
                                      num_latents=4, num_media_embeds=5),
        image_embed_len=4)


@pytest.fixture(scope="module")
def kosmos_pair():
    """A tiny Kosmos in both packages, an image, and the JAX engine's
    outputs for one multimodal and one text request."""
    jk = _tiny_kcfg(jcfg)
    jp = JKosmos.init(jax.random.PRNGKey(0), jk)
    img = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 3, 28, 28)))
    eng = JEngine(jp, jk.decoder,
                  JServeConfig(max_batch=2, max_prompt_len=12, max_len=64,
                               async_drain=False),
                  JSampling(greedy=True), kosmos_cfg=jk)
    hs = [eng.submit([3, 17, 9, 11, 22, 35, 51, 6], max_new_tokens=6,
                     images=jnp.asarray(img)),
          eng.submit([4, 8, 15, 16], max_new_tokens=6)]
    eng.run()
    tk = _tiny_kcfg(tcfg)
    model = TKosmos(tk, params=from_jax_params(_np_tree(jp), "cpu"))
    return model, tk, img, outputs(hs)


@pytest.mark.parametrize("setting", [dict(), dict(prefill_chunk=2),
                                     dict(prefill_chunk=3, sync_lag=2),
                                     dict(prefill_chunk=16)])
def test_multimodal_engine_matches_jax(kosmos_pair, setting):
    """A multimodal and a text request on a Kosmos engine (double
    embed-scale), admitted whole or chunked (the vision tower and the
    spliced prefix once, the text remainder streamed): JAX's outputs."""
    model, tk, img, ref = kosmos_pair
    eng = TEngine(model, tk.decoder,
                  TServeConfig(max_batch=2, max_prompt_len=12, max_len=64,
                               **setting),
                  TSampling(greedy=True), kosmos_cfg=tk, device="cpu")
    hs = [eng.submit([3, 17, 9, 11, 22, 35, 51, 6], max_new_tokens=6,
                     images=torch.tensor(img)),
          eng.submit([4, 8, 15, 16], max_new_tokens=6)]
    eng.run()
    assert_same(outputs(hs), ref)


OVERRUN_GRID = [dict(sync_lag=s, drain_batch=d, async_drain=a,
                     spec_gamma=g, decode_block=b)
                for s in (0, 1, 4) for d in (1, 2, 4) for a in (False, True)
                for g in (0, 3) for b in (0, 1, 4)]


def test_overrun_window_matches_jax():
    for kw in OVERRUN_GRID:
        assert tsc.ServeConfig(**kw).overrun_window == \
            jsc.ServeConfig(**kw).overrun_window, kw


@pytest.mark.parametrize("name", ["ServeConfig", "Request"])
def test_serve_config_mirror(name):
    """Same fields with the same defaults as the JAX dataclasses."""
    fj = [(f.name, f.default) for f in dataclasses.fields(getattr(jsc, name))]
    ft = [(f.name, f.default) for f in dataclasses.fields(getattr(tsc, name))]
    assert ft == fj


def test_suffix_prefill_takes_no_flash_branch(monkeypatch):
    """A prefix hit's suffix prefill writes past index 0, so attention runs
    over the cache (plain attention), never the prefill's flash branch,
    which holds only for a write at index 0: a 300-token suffix after a
    20-token prefix, flash on, calls no flash and gives the logits of a
    whole-prompt prefill (1e-4)."""
    import kosmosx_torch.nn.attention as tattn
    from kosmosx_torch.generate import sampler
    from kosmosx_torch.nn import decoder as tdec
    from kosmosx_torch.serve import programs

    cfg = dataclasses.replace(TCFG, use_flash_attention=True,
                              max_positions=512)
    model = TLanguage(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    calls = []
    inner = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    row = torch.randint(4, 97, (1, 320), generator=torch.Generator())
    caches = tdec.init_cache(cfg, 1, 330)
    x = tdec.forward_embedding(model, cfg, row[:, :20])[0]
    sampler._prefill(model, cfg, x, caches, torch.tensor([20]))
    assert calls == []
    first, lp = programs._prefill_suffix(
        model, row[:, 20:], torch.tensor([300]), 20, caches, None, cfg,
        TSampling(greedy=True))
    assert calls == []
    whole = sampler._prefill(model, cfg, tdec.forward_embedding(
        model, cfg, row)[0], tdec.init_cache(cfg, 1, 330), torch.tensor([320]))
    assert calls == [1] * cfg.layers       # the whole prompt takes flash
    assert int(first) == int(whole.argmax(-1))
    np.testing.assert_allclose(float(lp), float(torch.log_softmax(
        whole, -1)[0, int(first)]), atol=1e-4)
