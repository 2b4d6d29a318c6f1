"""kosmosx_torch's serving modes on the CPU: the mode matrix, the prefix
cache, multi-LoRA and speculative serving, and three fixes to JAX's
admission.

- The mode matrix mirrors tests/test_serve_matrix.py: the same
  ``UNSUPPORTED_MODE_PAIRS``; every supported singleton and pair gives the
  greedy tokens of the port's ``generate_text`` with the same numerics,
  every unsupported pair raises at the same call as in JAX, before
  anything is dispatched.
- Prefix copy and share, multi-LoRA (per slot) and speculative serving are
  held against the JAX engine on the same weights (``from_jax_params``):
  greedy tokens identical, log-probs within 1e-4.
"""

import dataclasses
from itertools import combinations

import jax
import numpy as np
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_torch.serve.config as tsc
import kosmosx_tpu.core.config as jcfg
import kosmosx_tpu.serve.config as jsc
from kosmosx_torch.generate.sampler import SamplingConfig as TSampling
from kosmosx_torch.generate.sampler import generate_text
from kosmosx_torch.models.language import KosmosLanguage as TLanguage
from kosmosx_torch.serve import ServeConfig as TServeConfig
from kosmosx_torch.serve import ServeEngine as TEngine
from kosmosx_torch.train import lora as tlora
from kosmosx_torch.utils.jax_params import from_jax_params
from kosmosx_torch.utils.quantize import quantize_params_w8
from kosmosx_tpu.generate import SamplingConfig as JSampling
from kosmosx_tpu.nn import decoder as jdec
from kosmosx_tpu.serve import ServeConfig as JServeConfig
from kosmosx_tpu.serve import ServeEngine as JEngine
from kosmosx_tpu.train import lora as jlora
from tests.test_torch_port_serve import (CFG_KW, JCFG, TCFG, _np_tree,
                                         assert_same, outputs, port_model)

NEW = 6
MODES = ("blocked", "chunked", "kv_window", "spec", "kv8", "w8",
         "prefix_copy", "prefix_share", "adapter", "sampling_override")


def _toks(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(4, 97, n)]


PREF_A = _toks(101, 6)   # the shared segment
PREF_B = _toks(102, 6)   # the copy-mode prefix


@pytest.fixture(scope="module")
def jparams():
    return jdec.init_decoder(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tmodel(jparams):
    return port_model(jparams)


def _jax_adapter(params, seed, scale=0.1):
    """Random adapter factors of rank 3 (b nonzero), as
    tests/test_multilora.py makes them."""
    key = jax.random.PRNGKey(seed)
    tree = jlora.strip_lora(jlora.add_lora(key, params, rank=3))[1]

    def randomize(path, x):
        last = [p.key for p in path if hasattr(p, "key")][-1]
        if last in ("a", "b"):
            k = jax.random.fold_in(key, len(jax.tree_util.keystr(path)))
            return jax.random.normal(k, x.shape, x.dtype) * scale
        return x

    return jax.tree_util.tree_map_with_path(randomize, tree)


@pytest.fixture(scope="module")
def adapters(jparams):
    """Two JAX adapters and their port trees."""
    out = {}
    for name, seed in (("A", 11), ("B", 22)):
        j = _jax_adapter(jparams, seed)
        out[name] = (j, from_jax_params(_np_tree(j), "cpu"))
    return out


def _engine(model, cfg=TCFG, draft=None, **scfg):
    kw = dict(max_batch=2, max_prompt_len=12, max_len=48)
    kw.update(scfg)
    return TEngine(model, cfg, TServeConfig(**kw), TSampling(greedy=True),
                   draft_params=None if draft is None else draft[0],
                   draft_cfg=None if draft is None else draft[1],
                   device="cpu")


# -- the mode matrix -----------------------------------------------------------


def test_unsupported_mode_pairs_are_jax_s():
    assert tsc.UNSUPPORTED_MODE_PAIRS == jsc.UNSUPPORTED_MODE_PAIRS
    for a, b in combinations(MODES + ("multimodal",), 2):
        assert tsc.unsupported_reason(a, b) == jsc.unsupported_reason(a, b)


def _requests(modes):
    """Two requests exercising the request-scoped modes of ``modes``
    (tests/test_serve_matrix.py:_build_requests)."""
    reqs = []
    for i, seed in enumerate((7, 8)):
        prompt = _toks(seed, 3 + 2 * i)
        kind = "base"
        if "prefix_share" in modes and ("prefix_copy" not in modes or i == 0):
            prompt = PREF_A + prompt
        elif "prefix_copy" in modes:
            prompt = PREF_B + prompt
        kw = {}
        if "adapter" in modes and i == 1:
            kw["adapter"] = "t1"
            kind = "adapter"
        if "sampling_override" in modes and i == 1:
            kw["temperature"] = 0.0
        reqs.append((prompt, kw, kind))
    return reqs


def _scenario(modes, tmodel, adapter, dispatched):
    cfg = dataclasses.replace(
        TCFG, kv_cache_dtype="int8" if "kv8" in modes else None,
        kv_window=32 if "kv_window" in modes else 0, kv_sink=2)
    model = port_model_cfg(tmodel, cfg)
    if "w8" in modes:
        model = quantize_params_w8(model)
    draft = None
    if "spec" in modes:
        dcfg = dataclasses.replace(cfg, layers=1)
        draft = (TLanguage(dcfg, generator=torch.Generator().manual_seed(5),
                           device="cpu"), dcfg)
    eng = _engine(model, cfg, draft,
                  decode_block=2 if "blocked" in modes else 0,
                  prefill_chunk=4 if "chunked" in modes else 0,
                  spec_gamma=2 if "spec" in modes else 0)
    if "adapter" in modes:
        eng.load_adapter("t1", adapter)
    if "prefix_share" in modes:
        eng.register_prefix(PREF_A, share=True)
    if "prefix_copy" in modes:
        eng.register_prefix(PREF_B)
    reqs = _requests(modes)
    handles = [eng.submit(p, max_new_tokens=NEW, **kw) for p, kw, _ in reqs]
    # past this point nothing may raise
    dispatched.append(True)
    eng.run()
    assert all(h.done for h in handles)
    ref_params = {"base": model,
                  "adapter": tlora.attach_lora(model, adapter)}
    for (p, _, kind), h in zip(reqs, handles):
        ref = generate_text(ref_params[kind], cfg, torch.tensor([p]),
                            TSampling(max_new_tokens=NEW, greedy=True))
        assert h.tokens == ref[0].tolist(), ("+".join(modes), kind)


def port_model_cfg(model, cfg):
    """``model``'s parameters under another config (shared tensors)."""
    return TLanguage(cfg, params=tlora.as_tree(model))


@pytest.fixture(scope="module")
def matrix_adapter(adapters):
    return adapters["A"][1]


@pytest.mark.parametrize(
    "modes", [(m,) for m in MODES] + list(combinations(MODES, 2)),
    ids=lambda m: "+".join(m))
def test_mode_matrix(modes, tmodel, matrix_adapter):
    """Supported singletons and pairs: ``generate_text``'s greedy tokens
    with the same numerics; unsupported pairs raise NotImplementedError at
    construction, load_adapter or submit, as in JAX."""
    dispatched = []
    if tsc.unsupported_reason(*modes) is not None:
        with pytest.raises(NotImplementedError):
            _scenario(modes, tmodel, matrix_adapter, dispatched)
        assert not dispatched, f"{'+'.join(modes)} raised mid-flight"
    else:
        _scenario(modes, tmodel, matrix_adapter, dispatched)


# -- prefix cache, multi-LoRA and speculative serving against JAX ------------


PREFIX = [5, 11, 23, 42, 7, 9]
SUFFIXES = [[30, 31], [40, 41, 42, 43], [50], [60, 61, 62]]


def _serve(eng, prompts, adapters_of=None):
    hs = [eng.submit(p, max_new_tokens=NEW,
                     adapter=None if adapters_of is None else adapters_of[i])
          for i, p in enumerate(prompts)]
    eng.run()
    return outputs(hs)


@pytest.fixture(scope="module")
def jax_prefix_ref(jparams):
    """The JAX engine on prefix + suffix prompts, no prefix registered."""
    eng = JEngine(jparams, JCFG,
                  JServeConfig(max_batch=2, max_prompt_len=16, max_len=48),
                  JSampling(greedy=True))
    return _serve(eng, [PREFIX + s for s in SUFFIXES] + [[70, 71]])


@pytest.mark.parametrize("share,setting", [
    (False, dict()), (False, dict(sync_lag=2, decode_block=2)),
    (False, dict(prefill_chunk=4)), (True, dict()),
    (True, dict(sync_lag=1, decode_block=3)), (True, dict(prefill_chunk=4))])
def test_prefix_cache_matches_jax(tmodel, jax_prefix_ref, share, setting):
    """Prefix hits (copy: the K/V copied into the slot, the suffix written
    into the slot's row; share: one broadcast segment) give the JAX
    engine's full-prefill outputs; a prompt without the prefix misses."""
    eng = _engine(tmodel, max_prompt_len=16, **setting)
    eng.register_prefix(PREFIX, share=share)
    got = _serve(eng, [PREFIX + s for s in SUFFIXES] + [[70, 71]])
    assert_same(got, jax_prefix_ref)
    assert eng.prefix_hits == len(SUFFIXES)


def test_prefix_cache_lru_and_longest_match(tmodel):
    """The LRU keeps ``prefix_cache_size`` entries, re-registering refreshes
    one, and the longest registered prefix wins a hit."""
    eng = _engine(tmodel, max_prompt_len=16, prefix_cache_size=2)
    eng.register_prefix(PREFIX[:2])
    eng.register_prefix(PREFIX[:4])
    eng.register_prefix(PREFIX[:2])          # refreshed: now the newest
    eng.register_prefix(PREFIX)              # evicts PREFIX[:4]
    assert list(eng.prefix_cache) == [tuple(PREFIX[:2]), tuple(PREFIX)]
    eng.register_prefix(PREFIX[:4])          # evicts PREFIX[:2]
    assert list(eng.prefix_cache) == [tuple(PREFIX), tuple(PREFIX[:4])]
    eng._match_prefix(PREFIX + [30])
    assert list(eng.prefix_cache)[-1] == tuple(PREFIX)   # longest won
    assert eng.prefix_hits == 1
    with pytest.raises(ValueError, match="prefix_cache_size"):
        _engine(tmodel, prefix_cache_size=0).register_prefix(PREFIX)


@pytest.mark.parametrize("share", [False, True])
def test_int8_prefix_matches_plain(tmodel, share):
    """An int8 pool: prefix hits give the int8 plain engine's outputs (the
    shared segment is dequantized once)."""
    cfg = dataclasses.replace(TCFG, kv_cache_dtype="int8")
    model = port_model_cfg(tmodel, cfg)
    prompts = [PREFIX + s for s in SUFFIXES]
    ref = _serve(_engine(model, cfg, max_prompt_len=16), prompts)
    eng = _engine(model, cfg, max_prompt_len=16)
    eng.register_prefix(PREFIX, share=share)
    got = _serve(eng, prompts)
    assert [t for t, _ in got] == [t for t, _ in ref]
    for (_, gl), (_, rl) in zip(got, ref):
        np.testing.assert_allclose(gl, rl, atol=1e-3, rtol=0)


def test_multi_lora_matches_jax(jparams, tmodel, adapters):
    """Per-slot adapters A and B beside base requests in one pool: the JAX
    multi-LoRA engine's outputs, and each request equal to a dedicated
    port engine whose base has its adapter attached."""
    prompts = [[5, 6, 7], [8, 9, 10, 11], [12, 13], [14, 15, 16]]
    names = ["A", "B", None, "A"]
    jeng = JEngine(jparams, JCFG,
                   JServeConfig(max_batch=3, max_prompt_len=16, max_len=48),
                   JSampling(greedy=True))
    for n, (j, _) in adapters.items():
        jeng.load_adapter(n, j)
    ref = _serve(jeng, prompts, names)
    eng = _engine(tmodel, max_batch=3, max_prompt_len=16)
    for n, (_, t) in adapters.items():
        eng.load_adapter(n, t)
    got = _serve(eng, prompts, names)
    assert_same(got, ref)
    for (toks, _), p, n in zip(got, prompts, names):
        base = tmodel if n is None else tlora.attach_lora(tmodel,
                                                          adapters[n][1])
        solo = _serve(_engine(base, max_batch=1, max_prompt_len=16), [p])
        assert toks == solo[0][0]


def test_adapter_slot_reuse_and_guards(tmodel, adapters):
    """A base request admitted into a slot an adapter request used decodes
    with zero factors; unknown or empty adapters raise."""
    eng = _engine(tmodel, max_batch=1, max_prompt_len=16)
    eng.load_adapter("A", adapters["A"][1])
    _serve(eng, [[5, 6, 7]], ["A"])
    got = _serve(eng, [[8, 9]])
    assert got == _serve(_engine(tmodel, max_batch=1, max_prompt_len=16),
                         [[8, 9]])
    with pytest.raises(KeyError, match="unknown adapter"):
        eng.submit([5, 6], adapter="nope")
    with pytest.raises(ValueError, match="no adapter factors"):
        eng.load_adapter("empty", {})


def test_adapter_requests_skip_the_shared_prefix(tmodel, adapters):
    """An adapter request matching the shared prefix keeps its whole prompt
    in its own cache: submit() counts it against max_len, and it decodes
    like a dedicated adapted engine."""
    prompt = PREFIX + [30, 31]
    a = adapters["A"][1]
    small = _engine(tmodel, max_prompt_len=16, max_len=2 + NEW,
                    async_drain=False)
    small.register_prefix(PREFIX, share=True)
    small.load_adapter("A", a)
    small.submit(prompt, max_new_tokens=NEW)
    with pytest.raises(ValueError, match="exceeds"):
        small.submit(prompt, max_new_tokens=NEW, adapter="A")
    eng = _engine(tmodel, max_prompt_len=16, max_len=32)
    eng.register_prefix(PREFIX, share=True)
    eng.load_adapter("A", a)
    got = _serve(eng, [prompt], ["A"])
    ref = _serve(_engine(tlora.attach_lora(tmodel, a), max_prompt_len=16,
                         max_len=32), [prompt])
    assert got[0][0] == ref[0][0]


@pytest.fixture(scope="module")
def draft(jparams):
    dcfg_kw = dict(CFG_KW, embed_dim=32, ffn_dim=64, layers=1)
    jd = jdec.init_decoder(jax.random.PRNGKey(9), jcfg.MagnetoConfig(**dcfg_kw))
    tcfg_d = tcfg.MagnetoConfig(**dcfg_kw)
    return TLanguage(tcfg_d, params=from_jax_params(_np_tree(jd), "cpu")), \
        tcfg_d


@pytest.fixture(scope="module")
def jax_plain_ref(jparams):
    from tests.test_torch_port_serve import WORK, serve

    eng = JEngine(jparams, JCFG,
                  JServeConfig(max_batch=3, max_prompt_len=16, max_len=256,
                               async_drain=False),
                  JSampling(greedy=True))
    return outputs(serve(eng, WORK))


@pytest.mark.parametrize("setting", [
    dict(), dict(sync_lag=2), dict(decode_block=2), dict(sync_lag=1,
                                                         decode_block=3),
    dict(drain_batch=2, sync_lag=1, async_drain=False),
    dict(drain_batch=2, sync_lag=2, decode_block=2)])
def test_spec_serving_matches_jax(tmodel, draft, jax_plain_ref, setting):
    """Speculative serving (gamma 3, a 1-layer draft) gives the JAX plain
    engine's greedy tokens and log-probs, for every lag and block."""
    from tests.test_torch_port_serve import WORK, serve

    eng = TEngine(tmodel, TCFG,
                  TServeConfig(max_batch=3, max_prompt_len=16, max_len=256,
                               spec_gamma=3, **setting),
                  TSampling(greedy=True), draft_params=draft[0],
                  draft_cfg=draft[1], device="cpu")
    assert_same(outputs(serve(eng, WORK)), jax_plain_ref)


def test_spec_self_draft_accepts(tmodel):
    """Draft == target: every proposal is accepted and the rounds
    collapse."""
    eng = TEngine(tmodel, TCFG,
                  TServeConfig(max_batch=2, max_prompt_len=16, max_len=64,
                               spec_gamma=3, async_drain=False),
                  TSampling(greedy=True), draft_params=tmodel,
                  draft_cfg=TCFG, device="cpu")
    h = eng.submit([5, 6, 7, 8], max_new_tokens=12)
    assert eng.run() <= 5
    assert h.done and len(h.tokens) == 12 and eng.accepted_total > 0


# -- three review findings of JAX's admission, fixed in the port -------------


def test_sampling_overrides_keep_the_batch_one_path(tmodel):
    """A request with a sampling override is not batchable: a group of
    eight free slots with one such request admits the other seven one by
    one (seven is below the bucket) and it alone through the batch-1 path
    with its rows, so the batched prefill never meets an override."""
    eng = _engine(tmodel, max_batch=8, max_prompt_len=16, max_len=64)
    hs = [eng.submit([5 + i, 6, 7], max_new_tokens=3,
                     temperature=0.0 if i == 3 else None) for i in range(8)]
    assert not eng._batchable(hs[3]) and eng._batchable(hs[0])
    eng.run()
    assert eng.prefills == 8                 # eight batch-1 prefills
    plain = _engine(tmodel, max_batch=8, max_prompt_len=16, max_len=64)
    ref = [plain.submit([5 + i, 6, 7], max_new_tokens=3) for i in range(8)]
    plain.run()
    assert (plain.prefills, plain.prefill_positions) == (1, 8 * 16)
    assert [h.tokens for h in hs] == [h.tokens for h in ref]


def test_batched_admission_has_one_group_size(tmodel):
    """``step`` batches groups of exactly ``_admit_bucket`` requests: nine
    requests into eight free slots make one prefill of eight rows and
    nothing else batched; seven admit one by one."""
    eng = _engine(tmodel, max_batch=8, max_prompt_len=16, max_len=64)
    for i in range(9):
        eng.submit([5 + i, 6], max_new_tokens=2)
    eng.step()
    assert eng._admit_bucket == 8
    assert (eng.prefills, eng.prefill_positions) == (1, 8 * 16)
    eng.run()
    assert (eng.prefills, eng.prefill_positions) == (2, 9 * 16)  # 9th alone
    eng = _engine(tmodel, max_batch=8, max_prompt_len=16, max_len=64)
    for i in range(7):
        eng.submit([5 + i, 6], max_new_tokens=2)
    eng.step()
    assert eng.prefills == 7
    from kosmosx_torch.serve import programs

    for fn in (type(eng)._admit_many, programs._prefill_one):
        assert "power of two" not in fn.__doc__


def test_warmup_warns_without_a_full_group(tmodel):
    """An engine whose max_len cannot hold a full batched-admission group
    of warmup requests says so, where JAX's branch did nothing."""
    eng = _engine(tmodel, max_batch=2, max_prompt_len=4, max_len=3,
                  async_drain=False)
    with pytest.warns(RuntimeWarning, match="batched-admission"):
        eng.warmup()
    roomy = _engine(tmodel, max_batch=2, max_prompt_len=4, max_len=16)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert roomy.warmup() == 3
