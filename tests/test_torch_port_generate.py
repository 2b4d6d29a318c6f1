"""kosmosx_torch generation against the JAX package: greedy tokens must be
identical for ragged prompts, with and without the decode-attention kernel,
and with a prompt long enough for the flash prefill.

Weights are carried across with ``from_jax_params``; JAX runs at fp32 with
matmul precision "highest" and ``interpret=True`` (Pallas kernels in
interpret mode); the port runs its plain kernel versions on the CPU.
"""

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
from kosmosx_torch.utils.jax_params import from_jax_params
from kosmosx_tpu.generate import sampler as jsamp
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.nn import decoder as jdec
from tests.test_torch_port_model import dec_cfg, kosmos_cfg

NEW = 6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ragged(rng, lengths, width, pad=1):
    toks = rng.integers(4, 97, (len(lengths), width)).astype(np.int32)
    for r, n in enumerate(lengths):
        toks[r, n:] = pad
    return toks


@pytest.mark.parametrize("decode_kernel,text_len", [
    (False, 12), (True, 12), (True, 250)],
    ids=["plain", "decode_kernel", "flash_prefill"])
def test_generate_multimodal_greedy_matches_jax(decode_kernel, text_len):
    cfg_j = kosmos_cfg(jcfg, decode_attn_kernel=decode_kernel)
    cfg_t = kosmos_cfg(tcfg, decode_attn_kernel=decode_kernel)
    params = JKosmos.init(jax.random.PRNGKey(10), cfg_j)
    model = TKosmos(cfg_t, params=from_jax_params(_np_tree(params)))
    rng = np.random.default_rng(10)
    lengths = np.array([text_len, text_len - 5, text_len - 2], np.int32)
    toks = _ragged(rng, lengths, text_len)
    images = rng.standard_normal((3, 3, 28, 28)).astype(np.float32)
    scfg_j = jsamp.SamplingConfig(max_new_tokens=NEW, greedy=True)
    with jax.default_matmul_precision("highest"):
        ref = jsamp.generate_multimodal(
            params, cfg_j, jnp.asarray(toks), jnp.asarray(images), scfg_j,
            prompt_lengths=jnp.asarray(lengths), interpret=True)
    out = tsamp.generate_multimodal(
        model, cfg_t, torch.from_numpy(toks).long(), torch.from_numpy(images),
        tsamp.SamplingConfig(max_new_tokens=NEW, greedy=True),
        prompt_lengths=torch.from_numpy(lengths))
    assert out.shape == (3, NEW)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("decode_kernel", [False, True],
                         ids=["plain", "decode_kernel"])
def test_generate_text_greedy_matches_jax(decode_kernel):
    cfg_j = dec_cfg(jcfg, decode_attn_kernel=decode_kernel)
    cfg_t = dec_cfg(tcfg, decode_attn_kernel=decode_kernel)
    params = jdec.init_decoder(jax.random.PRNGKey(11), cfg_j)
    model = TLanguage(cfg_t, params=from_jax_params(_np_tree(params)))
    lengths = np.array([9, 4], np.int32)
    toks = _ragged(np.random.default_rng(11), lengths, 9)
    with jax.default_matmul_precision("highest"):
        ref = jsamp.generate_text(
            params, cfg_j, jnp.asarray(toks),
            jsamp.SamplingConfig(max_new_tokens=NEW, greedy=True),
            prompt_lengths=jnp.asarray(lengths), interpret=True)
    out = tsamp.generate_text(
        model, cfg_t, torch.from_numpy(toks).long(),
        tsamp.SamplingConfig(max_new_tokens=NEW, greedy=True),
        prompt_lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampling_filters():
    """top-k keeps only the k best ids, top-p the smallest nucleus, and
    token_logprob matches a log-softmax gather."""
    logits = torch.tensor([[4.0, 3.0, 1.0, 0.0, -2.0]]).repeat(64, 1)
    g = torch.Generator().manual_seed(0)
    top2 = tsamp.sample_logits(logits, tsamp.SamplingConfig(top_k=2), g)
    assert set(top2.tolist()) <= {0, 1}
    nucleus = tsamp.sample_logits(logits, tsamp.SamplingConfig(top_p=0.5), g)
    assert set(nucleus.tolist()) == {0}
    greedy = tsamp.sample_logits(logits, tsamp.SamplingConfig(greedy=True))
    assert torch.all(greedy == 0)
    lp = tsamp.token_logprob(logits[:1], torch.tensor([1]))
    ref = jsamp.token_logprob(jnp.asarray(logits[:1].numpy()),
                              jnp.asarray([1]))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref), atol=1e-6)


def _jax_filter(logits, cfg):
    """The filtering of kosmosx_tpu/generate/sampler.py:81-93, as written."""
    logits = logits.astype(jnp.float32)
    if cfg.temperature != 1.0:
        logits = logits / jnp.maximum(cfg.temperature, 1e-6)
    if cfg.top_k > 0:
        kth = jnp.sort(logits, axis=-1)[:, -cfg.top_k][:, None]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if cfg.top_p < 1.0:
        sorted_logits = jnp.sort(logits, axis=-1)[:, ::-1]
        cum = jnp.cumsum(jax.nn.softmax(sorted_logits, axis=-1), axis=-1)
        cutoff_idx = jnp.sum(cum < cfg.top_p, axis=-1, keepdims=True)
        cutoff = jnp.take_along_axis(sorted_logits, cutoff_idx, axis=-1)
        logits = jnp.where(logits < cutoff, -jnp.inf, logits)
    return np.asarray(logits)


@pytest.mark.parametrize("shape,kw", [
    ((4, 32002), dict(top_p=0.99999999)),
    ((2, 50), dict(top_k=60)),
    ((3, 50), dict(top_k=7, top_p=0.9, temperature=0.7))],
    ids=["top_p_rounds_to_one", "top_k_past_vocab", "top_k_and_top_p"])
def test_sampling_keeps_the_token_set_of_jax(shape, kw):
    """The ids left after filtering (not -inf) are JAX's, where a top-p that
    rounds to 1 in fp32 puts the cutoff past the last id and where top-k
    exceeds the vocabulary; sampling from them draws a kept id. The draws
    themselves cannot match: the generators differ."""
    logits = np.random.default_rng(sum(shape)).standard_normal(shape) \
        .astype(np.float32)
    cfg = tsamp.SamplingConfig(**kw)
    kept = torch.isfinite(tsamp.filter_logits(torch.from_numpy(logits), cfg))
    want = np.isfinite(_jax_filter(jnp.asarray(logits),
                                   jsamp.SamplingConfig(**kw)))
    np.testing.assert_array_equal(kept.numpy(), want)
    ids = tsamp.sample_logits(torch.from_numpy(logits), cfg,
                              torch.Generator().manual_seed(0))
    assert bool(kept[torch.arange(shape[0]), ids].all())
