"""DPO in kosmosx_torch (``train/dpo.py``, ``preference_jsonl_batches``,
the training CLI's ``--dpo``) against the JAX package, on the CPU (fp32,
bar 1e-4 as tests/test_torch_parity.py:48; JAX at matmul precision
"highest").

The policy and the reference are two seeded torch inits of a tiny decoder
carried to JAX with ``to_numpy_params``; the JAX loss, its five metrics and
its gradients, with and without the reference term, come from one jitted
function shared by the module. Batches are numpy from both packages'
``preference_batch``, bit-identical.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.data.tokenizer import KosmosTokenizer as TTokenizer
from kosmosx_torch.models.language import KosmosLanguage as TLanguage
from kosmosx_torch.scripts import train as ttrain_cli
from kosmosx_torch.train import data as tdata
from kosmosx_torch.train import dpo as tdpo
from kosmosx_torch.train import optim as toptim
from kosmosx_torch.train import trainer as ttrainer
from kosmosx_torch.utils.jax_params import from_jax_params, to_numpy_params
from kosmosx_tpu.data.tokenizer import KosmosTokenizer as JTokenizer
from kosmosx_tpu.train import data as jdata
from kosmosx_tpu.train import dpo as jdpo
from kosmosx_tpu.train import optim as joptim
from test_torch_port_model import dec_cfg

TOL = dict(atol=1e-4, rtol=1e-4)
BETA = 0.5
METRICS = ("loss", "reward_margin", "reward_accuracy", "chosen_logp",
           "rejected_logp")


def _model(seed):
    return TLanguage(dec_cfg(tcfg), generator=torch.Generator().manual_seed(
        seed), device="cpu")


def _rows(rng, n, lo, hi):
    return [list(rng.integers(4, 97, int(rng.integers(lo, hi))))
            for _ in range(n)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


@pytest.fixture(scope="module")
def dpo_pair():
    """Policy and reference on both sides, a 4-row preference batch of
    length 20 (prompts 3-7 tokens, completions 2-9), the reference's
    log-probs from JAX, and JAX's loss, metrics and gradients with and
    without the reference term."""
    jc = dec_cfg(jcfg)
    policy, ref = _model(0), _model(1)
    jpolicy, jref = to_numpy_params(policy), to_numpy_params(ref)
    rng = np.random.default_rng(2)
    batch = jdpo.preference_batch(_rows(rng, 4, 3, 8), _rows(rng, 4, 2, 10),
                                  _rows(rng, 4, 2, 10), length=20)

    def jax_side(p, r, b):
        b = jdpo.compute_ref_logprobs(r, jc, b)
        out = {"ref": (b["ref_chosen_logp"], b["ref_rejected_logp"])}
        for free in (False, True):
            out[str(free)] = jax.value_and_grad(
                lambda pp: jdpo.dpo_loss_fn(jc, beta=BETA,
                                            reference_free=free)(pp, b, None),
                has_aux=True)(p)
        return out

    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax_side)(jpolicy, jref, batch)
    return policy, ref, batch, jax.tree_util.tree_map(np.asarray, want)


def test_sequence_logprob_and_ref_logprobs_match_jax(dpo_pair):
    """``compute_ref_logprobs`` (``sequence_logprob`` under no_grad) on
    the reference: both sides' log-probs within 1e-4, on the reference's
    device; the batch's own arrays untouched."""
    _, ref, batch, want = dpo_pair
    cfg = dec_cfg(tcfg)
    got = tdpo.compute_ref_logprobs(ref, cfg, batch)
    assert got["chosen"] is batch["chosen"]
    for i, side in enumerate(("chosen", "rejected")):
        t = got[f"ref_{side}_logp"]
        assert t.shape == (4,) and not t.requires_grad
        np.testing.assert_allclose(t.numpy(), want["ref"][i], **TOL)
    logits = ref.apply(torch.as_tensor(batch["chosen"]).long())
    logp = torch.log_softmax(logits, -1)[:, :-1]
    labels = torch.as_tensor(batch["chosen"][:, 1:]).long()
    manual = (logp.gather(-1, labels[..., None])[..., 0]
              * torch.as_tensor(batch["chosen_weights"][:, 1:])).sum(-1)
    np.testing.assert_allclose(got["ref_chosen_logp"].numpy(),
                               manual.detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("free", [False, True], ids=["ref", "reference_free"])
def test_dpo_loss_metrics_and_gradients_match_jax(dpo_pair, free):
    """``dpo_loss_fn``'s loss, its five metrics and every gradient within
    1e-4 of JAX's."""
    policy, ref, batch, want = dpo_pair
    cfg = dec_cfg(tcfg)
    tb = tdata.to_device(tdpo.compute_ref_logprobs(ref, cfg, batch), "cpu")
    (loss, metrics), grads = ttrainer.value_and_grad(
        tdpo.dpo_loss_fn(cfg, beta=BETA, reference_free=free), policy, tb)
    (jloss, jmetrics), jgrads = want[str(free)]
    np.testing.assert_allclose(loss.item(), jloss, **TOL)
    assert sorted(metrics) == sorted(METRICS) == sorted(jmetrics)
    for k in METRICS:
        np.testing.assert_allclose(metrics[k].item(), jmetrics[k], **TOL,
                                   err_msg=k)
    flat = _flat(jgrads)
    for n, g in grads.items():
        if g is None:  # a B expert: JAX's gradient is an exact zero
            assert not flat[n].any(), n
        else:
            np.testing.assert_allclose(g.numpy(), flat[n], **TOL, err_msg=n)


def test_dpo_step_matches_jax(dpo_pair):
    """One ``make_train_step`` of the DPO loss with AdamW (clip 1.0,
    masked decay) from the same gradients as JAX's optax chain: every
    parameter within 1e-4; the reference untouched."""
    policy, ref, batch, want = dpo_pair
    cfg = dec_cfg(tcfg)
    model = TLanguage(cfg, params=from_jax_params(to_numpy_params(policy), "cpu"))
    model.set_trainable()
    ref0 = {n: p.clone() for n, p in ref.named_parameters()}
    sched = toptim.make_schedule("constant", 1e-3, 10, 0)
    opt = toptim.make_optimizer("adamw", sched,
                                dict(model.named_parameters()))
    step = ttrainer.make_train_step(tdpo.dpo_loss_fn(cfg, beta=BETA), opt)
    step(model, tdata.to_device(tdpo.compute_ref_logprobs(ref, cfg, batch),
                                "cpu"))
    jopt = joptim.make_optimizer("adamw", joptim.make_schedule(
        "constant", 1e-3, 10, 0))
    jp = to_numpy_params(policy)
    grads = want["False"][1]
    flat = _flat(jax.jit(lambda g, p: optax.apply_updates(
        p, jopt.update(g, jopt.init(p), p)[0]))(grads, jp))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[n], **TOL,
                                   err_msg=n)
    assert all(torch.equal(p, ref0[n]) for n, p in ref.named_parameters())


def test_first_loss_is_ln2_when_the_reference_is_the_policy(dpo_pair):
    """With the reference an independent copy of the policy, the first
    DPO loss is ln 2 and the margin 0."""
    policy, _, batch, _ = dpo_pair
    cfg = dec_cfg(tcfg)
    ref = TLanguage(cfg, params=from_jax_params(to_numpy_params(policy), "cpu"))
    tb = tdata.to_device(tdpo.compute_ref_logprobs(ref, cfg, batch), "cpu")
    loss, m = tdpo.dpo_loss_fn(cfg, beta=BETA)(policy, tb, None)
    np.testing.assert_allclose(loss.item(), np.log(2.0), atol=1e-6)
    np.testing.assert_allclose(m["reward_margin"].item(), 0.0, atol=1e-6)


def test_preference_batch_bit_identical_to_jax():
    """Layout, padding and completion weights equal JAX's bit for bit,
    with and without ``length``; over-length rows raise."""
    rng = np.random.default_rng(3)
    args = (_rows(rng, 5, 1, 6), _rows(rng, 5, 1, 6), _rows(rng, 5, 1, 6))
    for kw in ({}, {"length": 14, "pad_id": 7}):
        got, want = tdpo.preference_batch(*args, **kw), \
            jdpo.preference_batch(*args, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="exceeds"):
        tdpo.preference_batch([[4, 5]], [[10, 11, 12]], [[20]], length=4)


def _prefs(path, n, seed):
    rng = np.random.default_rng(seed)
    words = "the a cat dog sat on mat ran far and jumped over".split()

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi))))

    path.write_text("\n".join(json.dumps(
        {"prompt": text(2, 5), "chosen": text(1, 4),
         "rejected": text(1, 4)}) for _ in range(n)) + "\n\n")
    return str(path)


def test_preference_jsonl_batches_bit_identical_to_jax(tmp_path):
    """Two epochs of 5 rows at batch 2 (the partial batch dropped), byte
    tokenizer on both sides: every array equal to JAX's."""
    path = _prefs(tmp_path / "prefs.jsonl", 5, 4)
    got = list(tdata.preference_jsonl_batches(
        path, TTokenizer(use_hf=False), batch_size=2, length=64, epochs=2))
    want = list(jdata.preference_jsonl_batches(
        path, JTokenizer(use_hf=False), batch_size=2, length=64, epochs=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


TINY = ["--layers", "2", "--dim", "32", "--ffn-dim", "64", "--heads", "4",
        "--device", "cpu", "--vocab-size", "300", "--seq-len", "64",
        "--batch-size", "2", "--steps", "3", "--log-every", "1",
        "--optimizer", "adamw", "--checkpoint-every", "0", "--lr", "1e-2",
        "--schedule", "constant", "--warmup-steps", "1"]


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
def test_dpo_cli_end_to_end(tmp_path, lora):
    """``--dpo PREFS.jsonl`` (and with ``--lora-rank 4``): exit 0, the five
    metrics logged each step and finite (the CLI keeps the config's
    dropout, so the first loss is not ln 2 as it is without); ``--model
    kosmos`` refused."""
    path = _prefs(tmp_path / "prefs.jsonl", 6, 5)
    log = tmp_path / "m.jsonl"
    argv = TINY + ["--dpo", path, "--dpo-beta", "0.5", "--output-dir",
                   str(tmp_path / "out"), "--metrics-jsonl", str(log),
                   "--no-final-save"] + (["--lora-rank", "4"] if lora else [])
    assert ttrain_cli.main(argv) == 0
    records = [json.loads(ln) for ln in log.read_text().splitlines() if ln]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r[k]) for r in records for k in METRICS)
    with pytest.raises(SystemExit, match="language"):
        ttrain_cli.main(argv + ["--model", "kosmos"])
