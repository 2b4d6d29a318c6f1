"""kosmosx_torch.train against kosmosx_tpu.train on the CPU.

The same numpy inputs, parameters and gradients go through both packages.
JAX runs at fp32 with matmul precision "highest" and the Pallas flash
kernels in interpret mode; the port runs its plain kernel versions. Bars:
1e-4 for losses, gradients and parameters after training steps
(tests/test_torch_parity.py:48); 1e-6 for optimizer updates fed the same
gradients, where both sides do the same fp32 arithmetic. Shapes are those of
tests/test_torch_port_model.py (decoder 2 layers, d 32; ViT on 28x28).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.models.kosmos import Kosmos as TKosmos
from kosmosx_torch.models.language import KosmosLanguage as TLanguage
from kosmosx_torch.train import checkpoint as tckpt
from kosmosx_torch.train import data as tdata
from kosmosx_torch.train import loss as tloss
from kosmosx_torch.train import optim as toptim
from kosmosx_torch.train import trainer as ttrainer
from kosmosx_torch.utils.jax_params import from_jax_params, to_numpy_params
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.train import data as jdata
from kosmosx_tpu.train import loss as jloss
from kosmosx_tpu.train import optim as joptim
from kosmosx_tpu.train import trainer as jtrainer
from test_torch_port_model import dec_cfg, kosmos_cfg

TOL = dict(atol=1e-4, rtol=1e-4)
OPT_TOL = dict(atol=1e-6, rtol=1e-6)


def _np(x):
    return np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    """name -> leaf of a nested dict/list tree, names joined by '.'."""
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


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("z_loss", [0.0, 1e-3], ids=["ce", "z_loss"])
def test_next_token_loss_matches_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 9, 17)).astype(np.float32) * 3
    labels = rng.integers(0, 17, (3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) > 0.3).astype(np.int32)
    loss_j, m_j = jloss.next_token_loss(jnp.asarray(logits), jnp.asarray(labels),
                                        jnp.asarray(mask), z_loss=z_loss)
    loss_t, m_t = tloss.next_token_loss(torch.from_numpy(logits),
                                        torch.from_numpy(labels),
                                        torch.from_numpy(mask), z_loss=z_loss)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)
    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), **TOL,
                                   err_msg=k)


def test_multimodal_loss_matches_jax():
    """The boundary alignment drops logits[s-1 : s+k-1]; pad labels are
    masked."""
    rng = np.random.default_rng(1)
    k, s = 4, 2
    text = rng.integers(4, 31, (2, 12)).astype(np.int32)
    text[1, 8:] = 1
    logits = rng.standard_normal((2, 12 + k, 31)).astype(np.float32)
    loss_j, m_j = jloss.multimodal_next_token_loss(
        jnp.asarray(logits), jnp.asarray(text), k, s, 1)
    loss_t, m_t = tloss.multimodal_next_token_loss(
        torch.from_numpy(logits), torch.from_numpy(text), k, s, 1)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)
    for key in m_j:
        np.testing.assert_allclose(float(m_t[key]), float(m_j[key]), **TOL,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# optimizers and schedules, fed the same gradients
# ---------------------------------------------------------------------------


def _opt_tree(rng):
    """A parameter tree with a decayed matmul weight, its multiway B twin
    that never gets a gradient, a LayerNorm scale and an embedding table
    (neither decayed)."""
    return {"embed": {"table": rng.standard_normal((6, 4)).astype(np.float32)},
            "layers": [{"attn": {
                "q": {"A": {"w": rng.standard_normal((4, 4)).astype(np.float32)},
                      "B": {"w": rng.standard_normal((4, 4)).astype(np.float32)}},
                "inner_ln": {"A": {"scale": np.ones(4, np.float32)}}}}]}


@pytest.mark.parametrize("name", toptim.OPTIMIZERS)
def test_optimizer_matches_optax(name):
    """Three updates with clipping at 1.0 (the gradients' norm is above it
    at steps 1-2 and below at step 3), masked decay, a zero-gradient B
    expert and a warmup from lr 0: parameters and grad_norm equal optax's
    make_optimizer chain."""
    rng = np.random.default_rng(2)
    tree = _opt_tree(rng)
    flat = _flat(tree)
    grads = [{n: rng.standard_normal(a.shape).astype(np.float32) * scale
              for n, a in flat.items() if ".B." not in n}
             for scale in (3.0, 0.5, 0.01)]
    sched_j = joptim.make_schedule("cosine", 0.05, 10, 2)
    opt_j = joptim.make_optimizer(name, sched_j, weight_decay=0.1)
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    state_j = opt_j.init(params_j)
    params_t = {n: torch.from_numpy(a.copy()) for n, a in flat.items()}
    opt_t = toptim.make_optimizer(
        name, toptim.make_schedule("cosine", 0.05, 10, 2), params_t,
        weight_decay=0.1)
    for step, g in enumerate(grads):
        g_tree = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(g.get(
                ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path), np.zeros_like(a))), tree)
        updates, state_j = opt_j.update(g_tree, state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        norm = opt_t.step({n: (torch.from_numpy(g[n]) if n in g else None)
                           for n in flat})
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g_tree)),
                                   **OPT_TOL)
        for n, a in _flat(params_j).items():
            np.testing.assert_allclose(params_t[n].numpy(), _np(a), **OPT_TOL,
                                       err_msg=f"{n} after step {step}")
    b = "layers.0.attn.q.B.w"
    assert not np.array_equal(params_t[b].numpy(), flat[b])  # decayed
    assert np.array_equal(params_t["embed.table"].numpy() != flat["embed.table"],
                          np.ones((6, 4), bool))


@pytest.mark.parametrize("name,warmup", [("cosine", 2), ("linear", 2),
                                         ("constant", 2), ("constant", 1),
                                         ("cosine", None)])
def test_schedule_matches_optax(name, warmup):
    sj = joptim.make_schedule(name, 3e-4, 20, warmup, final_scale=0.1)
    st = toptim.make_schedule(name, 3e-4, 20, warmup, final_scale=0.1)
    for step in range(6):
        np.testing.assert_allclose(st(step), float(sj(step)), rtol=1e-6,
                                   atol=0, err_msg=str(step))
    assert st(0) == 0.0


# ---------------------------------------------------------------------------
# the Kosmos train step against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kosmos_train_pair():
    """A tiny Kosmos on both sides, a batch of 250 text tokens (258 decoder
    positions: the flash path) with padding in row 1, and the JAX
    value_and_grad and train step of kosmos_loss_fn with interpret=True."""
    cfg_j, cfg_t = kosmos_cfg(jcfg), kosmos_cfg(tcfg)
    params = JKosmos.init(jax.random.PRNGKey(3), cfg_j)
    rng = np.random.default_rng(4)
    toks = rng.integers(4, 97, (2, 250)).astype(np.int32)
    toks[:, 0] = 0
    toks[1, 230:] = cfg_j.decoder.padding_idx
    images = rng.random((2, 3, 28, 28)).astype(np.float32)
    batch = {"text_tokens": toks, "images": images}

    def loss_fn(p, b, r):
        logits = JKosmos.apply(p, b["text_tokens"], b["images"], cfg_j,
                               use_padding_mask=True, rng=r, interpret=True)
        return jloss.multimodal_next_token_loss(
            logits, b["text_tokens"], cfg_j.image_embed_len,
            cfg_j.splice_index, cfg_j.decoder.padding_idx)

    trainable, frozen = jtrainer.split_frozen(params, ("clip",))
    with jax.default_matmul_precision("highest"):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda tr: loss_fn({**tr, **frozen}, batch, None),
            has_aux=True))(trainable)
    return cfg_j, cfg_t, params, batch, loss_fn, float(loss), grads


def test_weight_decay_mask_matches_jax(kosmos_train_pair):
    _, cfg_t, params, *_ = kosmos_train_pair
    mask_j = _flat(joptim.weight_decay_mask(params))
    model = TKosmos(cfg_t, params=from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    mask_t = toptim.weight_decay_mask(dict(model.named_parameters()))
    assert mask_t == {n: bool(v) for n, v in mask_j.items()}


def test_kosmos_train_step_gradients_match_jax(kosmos_train_pair):
    """Loss and every trainable gradient of one step, CLIP frozen."""
    cfg_j, cfg_t, params, batch, _, loss_j, grads_j = kosmos_train_pair
    model = TKosmos(cfg_t, params=from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    tbatch = tdata.to_device(batch, "cpu")
    (loss, _), grads = ttrainer.value_and_grad(
        ttrainer.kosmos_loss_fn(cfg_t), model, tbatch, freeze=("clip",))
    np.testing.assert_allclose(loss.item(), loss_j, **TOL)
    flat_j = _flat(grads_j)
    assert set(grads) == set(flat_j)
    assert not any(n.startswith("clip") for n in grads)
    for n, g in grads.items():
        ref = _np(flat_j[n])
        if g is None:  # a B expert: JAX's gradient is an exact zero
            assert ".B." in n and not ref.any(), n
        else:
            np.testing.assert_allclose(g.numpy(), ref, **TOL, err_msg=n)


def test_kosmos_adamw_steps_match_jax(kosmos_train_pair):
    """Three AdamW steps (clip 1.0, masked decay, constant lr after a
    one-step warmup from 0) through make_train_step on both sides: every
    parameter within 1e-4, the frozen CLIP tower bit-identical."""
    cfg_j, cfg_t, params, batch, loss_fn, _, _ = kosmos_train_pair
    sched_j = joptim.make_schedule("constant", 1e-3, 10, 1)
    opt_j = joptim.make_optimizer("adamw", sched_j, weight_decay=0.1)
    trainable_j, _ = jtrainer.split_frozen(params, ("clip",))
    state = {"params": params, "opt_state": opt_j.init(trainable_j),
             "step": jnp.zeros([], jnp.int32), "rng": jax.random.PRNGKey(0)}
    step_j = jax.jit(jtrainer.make_train_step(loss_fn, opt_j, freeze=("clip",)))

    model = TKosmos(cfg_t, params=from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    model.set_trainable(("clip",))
    trainable_t, frozen_t = ttrainer.split_frozen(model, ("clip",))
    clip0 = {n: p.detach().clone() for n, p in frozen_t.items()}
    opt_t = toptim.make_optimizer("adamw", toptim.make_schedule(
        "constant", 1e-3, 10, 1), trainable_t, weight_decay=0.1)
    step_t = ttrainer.make_train_step(ttrainer.kosmos_loss_fn(cfg_t), opt_t,
                                      freeze=("clip",))
    tbatch = tdata.to_device(batch, "cpu")
    losses_j, losses_t = [], []
    with jax.default_matmul_precision("highest"):
        for _ in range(3):
            state, m_j = step_j(state, batch)
            losses_j.append(float(m_j["loss"]))
            losses_t.append(step_t(model, tbatch)["loss"].item())
    np.testing.assert_allclose(losses_t, losses_j, **TOL)
    assert losses_t[0] == losses_t[1]  # step 0 ran at lr 0
    flat_j = _flat(jax.tree_util.tree_map(np.asarray, state["params"]))
    flat_t = _flat(to_numpy_params(model))
    assert set(flat_t) == set(flat_j)
    for n, a in flat_t.items():
        np.testing.assert_allclose(a, _np(flat_j[n]), **TOL, err_msg=n)
    assert all(torch.equal(p, clip0[n]) for n, p in frozen_t.items())


# ---------------------------------------------------------------------------
# remat, config, data, checkpoints
# ---------------------------------------------------------------------------


def test_remat_policies_match_no_remat():
    """remat "nothing" and "dots" give bit-identical loss and gradients to no
    remat on the CPU (flash path, 260 positions)."""
    cfg = dec_cfg(tcfg)
    model = TLanguage(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    batch = tdata.to_device(next(tdata.synthetic_text_batches(
        batch_size=2, seq_len=260, vocab_size=97)), "cpu")
    loss_fn = ttrainer.lm_loss_fn(cfg)
    (loss0, _), grads0 = ttrainer.value_and_grad(loss_fn, model, batch)
    for policy in ("nothing", "dots"):
        model.config = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        (loss, _), grads = ttrainer.value_and_grad(loss_fn, model, batch)
        assert torch.equal(loss, loss0), policy
        for n, g in grads.items():
            assert (g is None) == (grads0[n] is None), n
            assert g is None or torch.equal(g, grads0[n]), (policy, n)


def test_trainer_runs_on_the_card_unless_asked():
    """No device means the card, whether or not this machine has one;
    ``device="cpu"`` is the CPU."""
    tc = ttrainer.TrainConfig()
    assert ttrainer.Trainer(None, None, tc).device.type == "cuda"
    assert ttrainer.Trainer(None, None, tc, device="cpu").device.type == "cpu"


def test_train_config_mirror():
    """Same fields with the same defaults as the JAX TrainConfig."""
    fj = [(f.name, f.default) for f in dataclasses.fields(jtrainer.TrainConfig)]
    ft = [(f.name, f.default) for f in dataclasses.fields(ttrainer.TrainConfig)]
    assert ft == fj


@pytest.mark.parametrize("kind", ["text", "multimodal"])
def test_synthetic_batches_match_jax(kind):
    kw = dict(batch_size=2, seq_len=16, vocab_size=50, seed=0, steps=3)
    if kind == "text":
        jb, tb = jdata.synthetic_text_batches(**kw), \
            tdata.synthetic_text_batches(**kw)
    else:
        jb = jdata.synthetic_multimodal_batches(image_size=28, **kw)
        tb = tdata.synthetic_multimodal_batches(image_size=28, **kw)
    for a, b in itertools.zip_longest(jb, tb):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_to_numpy_params_inverts_from_jax_params():
    params = jax.tree_util.tree_map(
        np.asarray, JKosmos.init(jax.random.PRNGKey(5), kosmos_cfg(jcfg)))
    back = to_numpy_params(TKosmos(kosmos_cfg(tcfg),
                                   params=from_jax_params(params)))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def _lm_trainer(tmp_path, **kw):
    cfg = dec_cfg(tcfg)
    tc = ttrainer.TrainConfig(optimizer="adamw", schedule="cosine",
                              total_steps=10, warmup_steps=1,
                              learning_rate=1e-2, checkpoint_every=2,
                              log_every=1, output_dir=str(tmp_path), **kw)
    return ttrainer.Trainer(
        lambda g: TLanguage(cfg, generator=g, device="cpu"),
        ttrainer.lm_loss_fn(cfg), tc, device="cpu")


def test_checkpoint_resume_continues_exactly(tmp_path):
    """4 steps in one run equal 2 steps, a checkpoint, and a resumed run
    that skips the consumed batches and takes 2 more: parameters and
    optimizer moments bit-identical."""
    def batches():
        return tdata.synthetic_text_batches(batch_size=2, seq_len=24,
                                            vocab_size=97, seed=1)

    ref = _lm_trainer(tmp_path / "ref", prefetch=False)
    ref_state, _ = ref.run(batches(), steps=4)
    first = _lm_trainer(tmp_path / "run")
    first.run(batches(), steps=2)
    assert tckpt.latest_checkpoint(str(tmp_path / "run"))[1] == 2
    second = _lm_trainer(tmp_path / "run", resume=True)
    logged = []
    state, _ = second.run(batches(), steps=2,
                          log_fn=lambda step, m: logged.append(step))
    assert logged == [3, 4] and state["step"] == 4
    for (n, p), (_, q) in zip(state["params"].named_parameters(),
                              ref_state["params"].named_parameters()):
        assert torch.equal(p, q), n
    for n, mu in state["opt_state"].mu.items():
        assert torch.equal(mu, ref_state["opt_state"].mu[n]), n
    assert state["opt_state"].count == ref_state["opt_state"].count == 4


def test_params_save_restore_and_orbax_refusal(tmp_path):
    model = TLanguage(dec_cfg(tcfg), generator=torch.Generator().manual_seed(0),
                      device="cpu")
    tckpt.save_params(model, str(tmp_path / "final"))
    other = TLanguage(dec_cfg(tcfg), generator=torch.Generator().manual_seed(1),
                      device="cpu")
    tckpt.restore_params(str(tmp_path / "final"), other)
    for (n, p), (_, q) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(p, q), n
    orbax_dir = tmp_path / "step_5"
    orbax_dir.mkdir()
    (orbax_dir / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 9"):
        tckpt.restore_params(str(orbax_dir))


def test_trainer_eval_and_metrics(tmp_path):
    """run() logs the JAX metric names at step 1 and every log_every, with
    lr of the next step; evaluate() averages without touching parameters."""
    trainer = _lm_trainer(tmp_path, eval_every=2)
    logs = {}

    def evals():
        return tdata.synthetic_text_batches(batch_size=2, seq_len=24,
                                            vocab_size=97, seed=9, steps=2)

    trainer.run(tdata.synthetic_text_batches(batch_size=2, seq_len=24,
                                             vocab_size=97, seed=1),
                steps=2, log_fn=logs.__setitem__, eval_batches=evals)
    assert sorted(logs) == [1, 2]
    assert {"loss", "cross_entropy", "accuracy", "tokens", "perplexity",
            "grad_norm", "lr", "steps_per_sec"} <= set(logs[1])
    assert "eval_loss" in logs[2] and "eval_accuracy" in logs[2]
    assert logs[1]["lr"] == trainer.schedule(1)
    before = [p.clone() for p in trainer.state["params"].parameters()]
    trainer.evaluate(evals())
    assert all(torch.equal(a, b) for a, b in
               zip(before, trainer.state["params"].parameters()))
