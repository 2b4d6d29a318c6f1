"""kosmosx_torch's mixture-of-experts decoder against kosmosx_tpu's, on the CPU.

A tiny MoE decoder (2 layers, d 64, 4 experts of ffn 128, top-2, vocab 97,
fp32) is initialised in JAX and carried across with ``from_jax_params``.
Routing must make JAX's decisions exactly (the combine tensor bit for bit
from the same probabilities); the FFN's output is within 1e-5 and its aux
within 1e-6 in fp32 (2e-2 in bf16); the decoder's logits within 1e-4;
gradients of loss + aux within 1e-4 of each leaf's largest value; greedy,
beam, speculative and served tokens equal. JAX references are computed
once per module.
"""

import dataclasses
import json

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
from kosmosx_torch.nn import moe as tmoe
from kosmosx_torch.scripts import train as ttrain_cli
from kosmosx_torch.serve import ServeConfig as TServeConfig
from kosmosx_torch.serve import ServeEngine as TEngine
from kosmosx_torch.train import data as tdata
from kosmosx_torch.train import optim as toptim
from kosmosx_torch.train import trainer as ttrainer
from kosmosx_torch.train.lora import add_lora
from kosmosx_torch.utils.jax_params import from_jax_params, to_numpy_params
from kosmosx_torch.utils.quantize import quantize_params_w8
from kosmosx_tpu.generate import beam as jbeam
from kosmosx_tpu.generate import sampler as jsamp
from kosmosx_tpu.generate import speculative as jspec
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.nn import decoder as jdec
from kosmosx_tpu.nn import moe as jmoe
from kosmosx_tpu.train import loss as jloss
from kosmosx_tpu.train import optim as joptim
from kosmosx_tpu.train import trainer as jtrainer
from tests.test_torch_port_model import kosmos_cfg

TOL = dict(atol=1e-4, rtol=1e-4)
CFG_KW = dict(vocab_size=97, embed_dim=64, ffn_dim=128, layers=2, heads=4,
              max_positions=128, compute_dtype="float32", dropout=0.0,
              attention_dropout=0.0, multiway=False, use_flash_attention=False,
              moe_experts=4, moe_top_k=2)
JCFG = jcfg.MagnetoConfig(**CFG_KW)
TCFG = tcfg.MagnetoConfig(**CFG_KW)
D, F, E = 64, 128, 4


def _np(x):
    return np.asarray(x, np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


@pytest.fixture(scope="module")
def jparams():
    return jdec.init_decoder(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def model(jparams):
    return TLanguage(TCFG, params=from_jax_params(_np_tree(jparams), "cpu"))


@pytest.fixture(scope="module")
def ffn_params():
    p = jmoe.init_moe_ffn(jax.random.PRNGKey(1), D, F, E)
    return p, from_jax_params(_np_tree(p), "cpu")


# ---------------------------------------------------------------------------
# routing and the FFN
# ---------------------------------------------------------------------------


def _combine(expert, slot, gate, capacity):
    """The port's routing as JAX's dense (G, T, E, C) combine tensor."""
    k, g, t = expert.shape
    out = torch.zeros((g, t, E, capacity))
    gi = torch.arange(g)[None, :, None].expand(k, g, t)
    ti = torch.arange(t)[None, None, :].expand(k, g, t)
    out.index_put_((gi, ti, expert, slot.clamp_max(capacity - 1)), gate,
                   accumulate=True)
    return out


ROUTING = {  # top_k, capacity, pads
    "top1": (1, 3, False),
    "top2": (2, 4, False),
    "overflow": (2, 1, False),
    "pads": (2, 3, True),
    "no_drop": (2, 12, True),
}


@pytest.mark.parametrize("case", list(ROUTING))
def test_routing_combine_is_jax_bit_for_bit(case):
    top_k, capacity, pads = ROUTING[case]
    rng = np.random.default_rng(len(case))
    logits = rng.standard_normal((3, 12, E)).astype(np.float32) * 2
    logits[0, 5] = logits[0, 4]          # a tie: argmax takes the first
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    valid = None
    if pads:
        valid = rng.random((3, 12)) > 0.3
        valid[:, 0] = True
    want = jmoe._routing(jnp.asarray(probs), E, top_k, capacity,
                         valid=None if valid is None else jnp.asarray(valid))
    expert, slot, gate = tmoe._routing(
        _t(probs), E, top_k, capacity,
        valid=None if valid is None else _t(valid))
    got = _combine(expert, slot, gate, capacity).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    if case == "overflow":
        assert (got.sum(axis=(2, 3)) == 0).any()   # some tokens dropped
    if pads:
        assert not got[~valid].any()


@pytest.mark.parametrize("case", ["fp32", "fp32_pads", "no_drop", "bf16"])
def test_moe_ffn_matches_jax(ffn_params, case):
    jp, tp = ffn_params
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, D)).astype(np.float32)
    valid = None
    if case in ("fp32_pads", "no_drop"):
        valid = np.ones((2, 16), bool)
        valid[1, 9:] = False
    kw = dict(num_experts=E, top_k=2, capacity_factor=1.0,
              no_drop=case == "no_drop")
    dt = (jnp.bfloat16, torch.bfloat16) if case == "bf16" else \
        (jnp.float32, torch.float32)
    with jax.default_matmul_precision("highest"):
        yj, auxj = jmoe.moe_ffn(
            jp, jnp.asarray(x, dt[0]), dtype=dt[0],
            valid=None if valid is None else jnp.asarray(valid), **kw)
    yt, auxt = tmoe.moe_ffn(tp, _t(x).to(dt[1]), dtype=dt[1],
                            valid=None if valid is None else _t(valid), **kw)
    assert yt.dtype == dt[1] and auxt.dtype == torch.float32
    bar = 2e-2 if case == "bf16" else 1e-5
    np.testing.assert_allclose(yt.float().numpy(), _np(yj), atol=bar, rtol=bar)
    np.testing.assert_allclose(auxt.item(), float(auxj),
                               atol=2e-2 if case == "bf16" else 1e-6, rtol=0)
    if valid is not None:
        assert not yt[~_t(valid)].any()


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_dense_oracle(ffn_params, top_k):
    """Capacity E drops nothing: the routed FFN is the dense oracle, and the
    port's oracle is JAX's."""
    jp, tp = ffn_params
    x = np.random.default_rng(top_k).standard_normal((2, 8, D)).astype(
        np.float32)
    y, aux = tmoe.moe_ffn(tp, _t(x), num_experts=E, top_k=top_k,
                          capacity_factor=E)
    ref = tmoe.moe_ffn_dense_oracle(tp, _t(x), num_experts=E, top_k=top_k)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    assert aux.item() > 0
    with jax.default_matmul_precision("highest"):
        jref = jmoe.moe_ffn_dense_oracle(jp, jnp.asarray(x), num_experts=E,
                                         top_k=top_k)
    np.testing.assert_allclose(ref.numpy(), _np(jref), atol=1e-5, rtol=1e-5)


def test_moe_capacity_overflow_drops_to_zero():
    """One expert, top-1, one slot: only each row's first token is served."""
    tp = tmoe.init_moe_ffn(torch.Generator().manual_seed(5), 8, 16, 1,
                           device="cpu")
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(6))
    assert tmoe.moe_capacity(5, 1, 1, 0.05) == 1
    y, _ = tmoe.moe_ffn(tp, x, num_experts=1, top_k=1, capacity_factor=0.05)
    assert y[:, 0].abs().max() > 0
    assert not y[:, 1:].any()


def test_moe_padding_independence(ffn_params):
    """With no_drop, a token's output does not depend on the padding in
    its group, and pads give exactly zero."""
    _, tp = ffn_params
    x = torch.randn(2, 5, D, generator=torch.Generator().manual_seed(7))
    y, _ = tmoe.moe_ffn(tp, x, num_experts=E, valid=torch.ones(2, 5, dtype=bool),
                        no_drop=True)
    for pad in (3, 11):
        xp = torch.cat([x, torch.zeros(2, pad, D)], dim=1)
        valid = torch.arange(5 + pad)[None].expand(2, -1) < 5
        yp, _ = tmoe.moe_ffn(tp, xp, num_experts=E, valid=valid, no_drop=True)
        torch.testing.assert_close(yp[:, :5], y, atol=1e-6, rtol=0)
        assert not yp[:, 5:].any()


def test_moe_load_balance_is_one_when_uniform(ffn_params):
    _, tp = ffn_params
    tp = {**tp, "router": {"w": torch.zeros(D, E)}}
    x = torch.randn(1, 8, D, generator=torch.Generator().manual_seed(8))
    _, aux = tmoe.moe_ffn(tp, x, num_experts=E, aux_weight=1.0, z_weight=0.0)
    assert abs(aux.item() - 1.0) < 1e-6
    _, auxz = tmoe.moe_ffn(tp, x, num_experts=E, aux_weight=0.0, z_weight=1.0)
    assert abs(auxz.item() - float(np.log(4.0) ** 2)) < 1e-5


# ---------------------------------------------------------------------------
# the decoder, gradients, training
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(9)
    toks = rng.integers(4, 97, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, 17:] = 0
    return {"input_ids": toks, "attention_mask": mask}


@pytest.fixture(scope="module")
def jforward(jparams, batch):
    seg = jnp.where(jnp.asarray(batch["attention_mask"]) > 0, 0, -1)
    with jax.default_matmul_precision("highest"):
        logits, aux = jax.jit(lambda p, t, s: jdec.decoder_forward(
            p, t, JCFG, segment_ids=s, with_aux=True))(
                jparams, jnp.asarray(batch["input_ids"]), seg)
    return _np(logits), float(aux)


@pytest.mark.parametrize("layout", ["list", "stacked", "flash"])
def test_decoder_forward_with_aux_matches_jax(jparams, batch, jforward, layout):
    """Logits within 1e-4 and the summed aux of the per-layer, the
    ``scan_layers`` stack (carried across as stacked (L, E, ...) leaves)
    and the flash path (its plain version on the CPU)."""
    cfg = dataclasses.replace(TCFG, use_flash_attention=layout == "flash")
    tree = _np_tree(jparams)
    if layout == "stacked":
        tree = dict(tree, layers=jax.tree_util.tree_map(
            lambda *xs: np.stack(xs), *tree["layers"]))
        assert tree["layers"]["ffn"]["experts"]["fc1"]["w"].shape == (2, E, D, F)
    m = TLanguage(cfg, params=from_jax_params(tree, "cpu"))
    assert tuple(m["layers"][1]["ffn"]["experts"]["fc1"]["w"].shape) == (E, D, F)
    seg = torch.where(_t(batch["attention_mask"]) > 0, 0, -1).int()
    logits, aux = m.apply(_t(batch["input_ids"]).long(), segment_ids=seg,
                          with_aux=True)
    np.testing.assert_allclose(logits.numpy(), jforward[0], **TOL)
    np.testing.assert_allclose(aux.item(), jforward[1], atol=1e-6, rtol=0)
    assert torch.equal(m.apply(_t(batch["input_ids"]).long(), segment_ids=seg),
                       logits)


@pytest.fixture(scope="module")
def jgrads(jparams, batch):
    loss_fn = jtrainer.lm_loss_fn(JCFG)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, jbatch, None), has_aux=True))(jparams)
    return float(loss), float(metrics["moe_aux"]), _flat(_np_tree(grads))


def test_loss_and_gradients_match_jax(model, batch, jgrads):
    """loss + aux and the gradient of every leaf (router and expert stacks
    among them) within 1e-4 of the leaf's largest value."""
    loss_j, aux_j, grads_j = jgrads
    (loss, metrics), grads = ttrainer.value_and_grad(
        ttrainer.lm_loss_fn(TCFG), model, tdata.to_device(batch, "cpu"))
    np.testing.assert_allclose(loss.item(), loss_j, **TOL)
    np.testing.assert_allclose(metrics["moe_aux"].item(), aux_j, atol=1e-6)
    assert set(grads) == set(grads_j)
    for n, g in grads.items():
        ref = _np(grads_j[n])
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4 * scale, rtol=0,
                                   err_msg=n)
    for layer in range(2):
        for leaf in ("fc1", "fc2"):
            g = grads[f"layers.{layer}.ffn.experts.{leaf}.w"]
            assert all(g[e].abs().max() > 0 for e in range(E)), (layer, leaf)


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_remat_policies_match_no_remat(model, batch, policy):
    """Each remat policy gives the loss, aux and gradients of no remat:
    the checkpointed layer returns its aux beside its output."""
    tbatch = tdata.to_device(batch, "cpu")
    (loss0, m0), grads0 = ttrainer.value_and_grad(ttrainer.lm_loss_fn(TCFG),
                                                  model, tbatch)
    cfg = dataclasses.replace(TCFG, remat=True, remat_policy=policy)
    model.config = cfg
    try:
        (loss, m), grads = ttrainer.value_and_grad(ttrainer.lm_loss_fn(cfg),
                                                   model, tbatch)
    finally:
        model.config = TCFG
    assert torch.equal(loss, loss0) and torch.equal(m["moe_aux"], m0["moe_aux"])
    for n, g in grads.items():
        torch.testing.assert_close(g, grads0[n], atol=1e-6, rtol=0)


def test_adamw_steps_with_moe_aux_match_jax(jparams, batch):
    """Two AdamW steps through make_train_step on both sides: losses,
    ``moe_aux`` and every parameter within 1e-4."""
    loss_fn = jtrainer.lm_loss_fn(JCFG)
    opt_j = joptim.make_optimizer(
        "adamw", joptim.make_schedule("constant", 1e-3, 10, 0),
        weight_decay=0.1)
    state = {"params": jparams, "opt_state": opt_j.init(jparams),
             "step": jnp.zeros([], jnp.int32), "rng": jax.random.PRNGKey(0)}
    step_j = jax.jit(jtrainer.make_train_step(loss_fn, opt_j))
    m = TLanguage(TCFG, params=from_jax_params(_np_tree(jparams), "cpu"))
    m.set_trainable()
    opt_t = toptim.make_optimizer(
        "adamw", toptim.make_schedule("constant", 1e-3, 10, 0),
        dict(m.named_parameters()), weight_decay=0.1)
    step_t = ttrainer.make_train_step(ttrainer.lm_loss_fn(TCFG), opt_t)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = tdata.to_device(batch, "cpu")
    with jax.default_matmul_precision("highest"):
        for _ in range(2):
            state, mj = step_j(state, jbatch)
            mt = step_t(m, tbatch)
            np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]),
                                       **TOL)
            np.testing.assert_allclose(mt["moe_aux"].item(),
                                       float(mj["moe_aux"]), atol=1e-6)
    flat_j = _flat(_np_tree(state["params"]))
    flat_t = _flat(to_numpy_params(m))
    assert set(flat_t) == set(flat_j)
    for n, a in flat_t.items():
        np.testing.assert_allclose(a, _np(flat_j[n]), **TOL, err_msg=n)


def test_trainer_runs_moe_and_reports_moe_aux(tmp_path):
    cfg = dataclasses.replace(TCFG, use_flash_attention=True)
    trainer = ttrainer.Trainer(
        init_fn=lambda g: TLanguage(cfg, generator=g, device="cpu"),
        loss_fn=ttrainer.lm_loss_fn(cfg),
        cfg=ttrainer.TrainConfig(batch_size=2, seq_len=24, learning_rate=1e-2,
                                 optimizer="adamw", schedule="constant",
                                 warmup_steps=0, checkpoint_every=0,
                                 output_dir=str(tmp_path), prefetch=False),
        device="cpu")
    logs = {}
    batches = [next(tdata.synthetic_text_batches(batch_size=2, seq_len=24,
                                                 vocab_size=97))] * 4
    _, metrics = trainer.run(iter(batches), log_fn=logs.__setitem__)
    assert "moe_aux" in metrics and metrics["moe_aux"].item() > 0
    assert logs[1]["loss"] > metrics["loss"].item()


def test_kosmos_with_aux_matches_jax():
    """The multimodal model with an MoE decoder (multiway attention):
    logits and aux of ``apply(with_aux=True)``, and kosmos_loss_fn's
    loss, the CE plus moe_aux, as JAX's kosmos_loss_fn adds them."""
    cfg_j = kosmos_cfg(jcfg, moe_experts=4, use_flash_attention=False)
    cfg_t = kosmos_cfg(tcfg, moe_experts=4, use_flash_attention=False)
    params = JKosmos.init(jax.random.PRNGKey(11), cfg_j)
    rng = np.random.default_rng(11)
    toks = rng.integers(4, 97, (2, 12)).astype(np.int32)
    toks[1, 9:] = 1
    images = rng.random((2, 3, 28, 28)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        logits_j, aux_j = jax.jit(lambda p, t, i: JKosmos.apply(
            p, t, i, cfg_j, use_padding_mask=True, interpret=True,
            with_aux=True))(params, jnp.asarray(toks), jnp.asarray(images))
    loss_j = jloss.multimodal_next_token_loss(
        logits_j, jnp.asarray(toks), cfg_j.image_embed_len,
        cfg_j.splice_index, cfg_j.decoder.padding_idx)[0] + aux_j
    m = TKosmos(cfg_t, params=from_jax_params(_np_tree(params), "cpu"))
    logits, aux = m.apply(_t(toks).long(), _t(images), use_padding_mask=True,
                          with_aux=True)
    np.testing.assert_allclose(logits.numpy(), _np(logits_j), **TOL)
    np.testing.assert_allclose(aux.item(), float(aux_j), atol=1e-6)
    loss, mt = ttrainer.kosmos_loss_fn(cfg_t)(
        m, tdata.to_device({"text_tokens": toks, "images": images}, "cpu"), None)
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    np.testing.assert_allclose(mt["moe_aux"].item(), float(aux_j), atol=1e-6)


# ---------------------------------------------------------------------------
# generation and serving (the cache makes routing no-drop)
# ---------------------------------------------------------------------------

PROMPTS = ([5, 9, 2, 33], [7, 3, 5, 22, 8, 11, 40], [12, 4],
           [30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40])
ALONE = (2, 3)


def _ragged(prompts):
    toks = np.ones((len(prompts), max(map(len, prompts))), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks, np.array([len(p) for p in prompts], np.int32)


@pytest.fixture(scope="module")
def jgenerated(jparams):
    """JAX's greedy tokens of the right-padded batch, of the shortest and
    longest prompts alone (unpadded), the batch's beams and its speculative
    tokens with a 1-layer MoE draft."""
    toks, lengths = _ragged(PROMPTS)
    scfg = jsamp.SamplingConfig(max_new_tokens=6, greedy=True)
    draft_cfg = dataclasses.replace(JCFG, layers=1)
    draft = jdec.init_decoder(jax.random.PRNGKey(2), draft_cfg)
    with jax.default_matmul_precision("highest"):
        alone = {i: np.asarray(jsamp.generate_text(
            jparams, JCFG, jnp.asarray([PROMPTS[i]], jnp.int32), scfg))[0]
            for i in ALONE}
        batch = np.asarray(jsamp.generate_text(
            jparams, JCFG, jnp.asarray(toks), scfg,
            prompt_lengths=jnp.asarray(lengths)))
        beams = jbeam.beam_search(jparams, JCFG, jnp.asarray(toks),
                                  beam_size=3, max_new_tokens=5,
                                  prompt_lengths=jnp.asarray(lengths))
        spec, stats = jspec.speculative_generate(
            jparams, draft, JCFG, draft_cfg, jnp.asarray(toks), scfg, gamma=3,
            prompt_lengths=jnp.asarray(lengths))
    return {"alone": alone, "batch": batch, "beams": [np.asarray(b) for b in beams],
            "spec": (np.asarray(spec), stats), "draft": draft}


@pytest.mark.parametrize("mode", ["greedy", "beam", "speculative"])
def test_generation_matches_jax(model, jgenerated, mode):
    toks, lengths = _ragged(PROMPTS)
    scfg = tsamp.SamplingConfig(max_new_tokens=6, greedy=True)
    if mode == "greedy":
        got = tsamp.generate_text(model, TCFG, _t(toks).long(), scfg,
                                  prompt_lengths=_t(lengths))
        np.testing.assert_array_equal(got.numpy(), jgenerated["batch"])
        for i, want in jgenerated["alone"].items():
            np.testing.assert_array_equal(got[i].numpy(), want)
    elif mode == "beam":
        got = tbeam.beam_search(model, TCFG, _t(toks).long(), beam_size=3,
                                max_new_tokens=5, prompt_lengths=_t(lengths))
        ref = jgenerated["beams"]
        np.testing.assert_array_equal(got[0].numpy(), ref[0])
        np.testing.assert_allclose(got[1].numpy(), ref[1], **TOL)
        np.testing.assert_allclose(got[2].numpy(), ref[2], **TOL)
    else:
        draft_cfg = dataclasses.replace(TCFG, layers=1)
        draft = TLanguage(draft_cfg, params=from_jax_params(
            _np_tree(jgenerated["draft"]), "cpu"))
        out, stats = tspec.speculative_generate(
            model, draft, TCFG, draft_cfg, _t(toks).long(), scfg, gamma=3,
            prompt_lengths=_t(lengths))
        np.testing.assert_array_equal(out.numpy(), jgenerated["spec"][0])
        assert stats == jgenerated["spec"][1]
        np.testing.assert_array_equal(out.numpy(), jgenerated["batch"])


@pytest.mark.parametrize("admission", ["padded", "chunked"])
def test_engine_padded_prompts_match_jax_generate(model, jgenerated,
                                                  admission):
    """The engine pads every prompt to a prefill width; pads route nowhere
    and the cache's routing drops nothing, so each request's greedy tokens
    are JAX's ``generate_text``'s, which are those of its prompt alone."""
    kw = dict(max_batch=2, max_prompt_len=16, max_len=48, async_drain=False)
    if admission == "chunked":
        kw.update(max_batch=4, prefill_chunk=4)
    eng = TEngine(model, TCFG, TServeConfig(**kw),
                  tsamp.SamplingConfig(greedy=True), device="cpu")
    handles = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
    eng.run()
    for i, h in enumerate(handles):
        assert list(map(int, h.tokens)) == jgenerated["batch"][i].tolist()
        if i in jgenerated["alone"]:
            assert list(map(int, h.tokens)) == jgenerated["alone"][i].tolist()


# ---------------------------------------------------------------------------
# what JAX has no working path for, and the CLI
# ---------------------------------------------------------------------------


def test_w8_of_an_moe_decoder_raises(model):
    with pytest.raises(ValueError, match="MoE"):
        quantize_params_w8(model)


def test_lora_on_expert_stacks_raises(model):
    with pytest.raises(ValueError, match="expert"):
        add_lora(torch.Generator().manual_seed(0), model, 4)
    adapted = add_lora(torch.Generator().manual_seed(0), model, 4,
                       targets=("q", "v"))
    assert "lora" in adapted["layers"][0]["attn"]["q"]
    assert "lora" not in adapted["layers"][0]["ffn"]["experts"]["fc1"]


def test_train_cli_trains_moe(tmp_path):
    log = tmp_path / "m.jsonl"
    assert ttrain_cli.main([
        "--layers", "2", "--dim", "32", "--ffn-dim", "64", "--heads", "4",
        "--device", "cpu", "--synthetic", "--seq-len", "16", "--steps", "3",
        "--moe-experts", "4", "--moe-top-k", "2", "--no-multiway",
        "--log-every", "1", "--metrics-jsonl", str(log), "--no-final-save",
        "--output-dir", str(tmp_path / "out")]) == 0
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(records) == 3 and all(r["moe_aux"] > 0 for r in records)
