"""Gradient accumulation of kosmosx_torch's Trainer against
``optax.MultiSteps`` on the CPU, and checkpoints taken mid-accumulation.

A tiny Kosmos (tests/test_torch_port_model.py's shapes, 24 text tokens:
the plain attention path) trains on 6 distinct batches with CLIP frozen
and AdamW (clip 1.0, masked decay, a one-step warmup of a cosine
schedule). JAX runs ``make_train_step`` over ``optax.MultiSteps(chain,
k)`` jitted at matmul precision "highest"; the port runs ``Trainer.run``
with ``grad_accum=k``. Bars: every parameter within 1e-5 after the 6
micro-steps, the frozen tower bit-identical, the parameters unchanged
between updates (and at the first, which runs at lr 0); per micro-step
the logged ``grad_norm`` (that micro-step's own gradients) within 1e-4
relative of JAX's and ``lr`` the schedule at the micro-step's number, as
JAX logs it. A checkpoint at
micro-step 3 of ``grad_accum=2`` (the accumulator half full, 8-bit
moments, dropout on), resumed in a new Trainer, ends bit-identical to the
uninterrupted run.
"""

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
from kosmosx_torch.train import trainer as ttrainer
from kosmosx_torch.utils.jax_params import from_jax_params, to_numpy_params
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.train import loss as jloss
from kosmosx_tpu.train import optim as joptim
from kosmosx_tpu.train import trainer as jtrainer
from test_torch_port_model import dec_cfg, kosmos_cfg
from test_torch_port_train import _flat

MICRO_STEPS = 6
SCHED = ("cosine", 1e-3, 8, 1)


@pytest.fixture(scope="module")
def accum_setup():
    cfg_j = kosmos_cfg(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, JKosmos.init(jax.random.PRNGKey(8), cfg_j))
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(MICRO_STEPS):
        toks = rng.integers(4, 97, (2, 24)).astype(np.int32)
        toks[:, 0] = 0
        toks[1, 20:] = cfg_j.decoder.padding_idx
        batches.append({"text_tokens": toks, "images": rng.random(
            (2, 3, 28, 28)).astype(np.float32)})

    def loss_fn(p, b, r):
        logits = JKosmos.apply(p, b["text_tokens"], b["images"], cfg_j,
                               use_padding_mask=True, rng=r)
        return jloss.multimodal_next_token_loss(
            logits, b["text_tokens"], cfg_j.image_embed_len,
            cfg_j.splice_index, cfg_j.decoder.padding_idx)

    return params, batches, loss_fn


@pytest.mark.parametrize("k", [2, 3])
def test_grad_accum_matches_optax_multisteps(accum_setup, k):
    params, batches, loss_fn = accum_setup
    sched_j = joptim.make_schedule(*SCHED)
    opt_j = optax.MultiSteps(joptim.make_optimizer(
        "adamw", sched_j, weight_decay=0.1), k)
    trainable, _ = jtrainer.split_frozen(params, ("clip",))
    state = {"params": params, "opt_state": opt_j.init(trainable),
             "step": jnp.zeros([], jnp.int32), "rng": jax.random.PRNGKey(0)}
    step_j = jax.jit(jtrainer.make_train_step(loss_fn, opt_j,
                                              freeze=("clip",)))
    norms_j = []
    with jax.default_matmul_precision("highest"):
        for b in batches:
            state, m = step_j(state, b)
            norms_j.append(float(m["grad_norm"]))

    cfg_t = kosmos_cfg(tcfg)
    tc = ttrainer.TrainConfig(
        optimizer="adamw", schedule=SCHED[0], learning_rate=SCHED[1],
        total_steps=SCHED[2], warmup_steps=SCHED[3], grad_accum=k,
        freeze=("clip",), checkpoint_every=0, log_every=1, prefetch=False)
    trainer = ttrainer.Trainer(None, ttrainer.kosmos_loss_fn(cfg_t), tc,
                               device="cpu")
    model = TKosmos(cfg_t, params=from_jax_params(params))
    trainer.init_state(initial_params=model)
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if n.startswith("clip")}
    logs, snaps = {}, []

    def log_fn(step, m):
        logs[step] = m
        snaps.append(model["decoder"]["out_proj"]["w"].detach().clone())

    trainer.run(batches, log_fn=log_fn)
    assert sorted(logs) == list(range(1, MICRO_STEPS + 1))
    for step, m in logs.items():
        np.testing.assert_allclose(m["grad_norm"], norms_j[step - 1],
                                   rtol=1e-4, err_msg=str(step))
        assert m["lr"] == trainer.schedule(step)
    changed = [not torch.equal(a, b) for a, b in zip(
        [model["decoder"]["out_proj"]["w"].new_tensor(
            params["decoder"]["out_proj"]["w"])] + snaps[:-1], snaps)]
    # AdamW reads its 0-based count: the first inner update runs at lr 0
    assert changed == [(i + 1) % k == 0 and i + 1 > k
                       for i in range(MICRO_STEPS)]
    opt = trainer.state["opt_state"]
    assert opt.inner.count == MICRO_STEPS // k
    assert opt.mini_step == MICRO_STEPS % k
    flat_j = _flat(jax.tree_util.tree_map(np.asarray, state["params"]))
    for n, a in _flat(to_numpy_params(model)).items():
        np.testing.assert_allclose(a, np.asarray(flat_j[n], np.float32),
                                   atol=1e-5, rtol=1e-5, err_msg=n)
    assert all(torch.equal(p, frozen0[n]) for n, p in model.named_parameters()
               if n.startswith("clip"))


def _lm_trainer(out, **kw):
    cfg = dec_cfg(tcfg, dropout=0.1, attention_dropout=0.1)
    tc = ttrainer.TrainConfig(optimizer="adamw8bit", schedule="cosine",
                              total_steps=10, warmup_steps=1,
                              learning_rate=1e-2, grad_accum=2,
                              checkpoint_every=3, log_every=1,
                              output_dir=str(out), **kw)
    return ttrainer.Trainer(lambda g: TLanguage(cfg, generator=g, device="cpu"),
                            ttrainer.lm_loss_fn(cfg), tc, device="cpu")


def test_resume_mid_accumulation_continues_exactly(tmp_path):
    """6 micro-steps in one run equal 3 (a checkpoint with the accumulator
    half full), then a resumed run of 3 in a new Trainer: parameters,
    codes, scales, accumulator and losses bit-identical."""
    def batches():
        return tdata.synthetic_text_batches(batch_size=2, seq_len=24,
                                            vocab_size=97, seed=1)

    ref_logs = {}
    ref_state, _ = _lm_trainer(tmp_path / "ref", prefetch=False).run(
        batches(), steps=6, log_fn=ref_logs.__setitem__)
    _lm_trainer(tmp_path / "run").run(batches(), steps=3)
    saved = tckpt.latest_checkpoint(str(tmp_path / "run"))
    assert saved[1] == 3
    opt_saved = torch.load(saved[0] + "/state.pt", weights_only=True)["opt_state"]
    assert opt_saved["mini_step"] == 1
    assert any(t.any() for t in opt_saved["acc"].values())
    logs = {}
    state, _ = _lm_trainer(tmp_path / "run", resume=True).run(
        batches(), steps=3, log_fn=logs.__setitem__)
    assert sorted(logs) == [4, 5, 6] and state["step"] == 6
    for step in (4, 5, 6):
        assert logs[step]["loss"] == ref_logs[step]["loss"], step
    for (n, p), (_, q) in zip(state["params"].named_parameters(),
                              ref_state["params"].named_parameters()):
        assert torch.equal(p, q), n
    got, want = state["opt_state"].state_dict(), \
        ref_state["opt_state"].state_dict()
    assert got["mini_step"] == want["mini_step"] == 0
    assert got["acc"] is want["acc"] is None  # all zeros at a boundary
    for n, t in ref_state["opt_state"].acc.items():
        assert torch.equal(state["opt_state"].acc[n], t) and not t.any(), n
    for slot in ("mu", "nu"):
        for n, qs in want["inner"][slot].items():
            for key in ("q", "scale"):
                assert torch.equal(got["inner"][slot][n][key], qs[key])
    assert got["inner"]["count"] == want["inner"]["count"] == 3
