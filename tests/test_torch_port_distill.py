"""Draft distillation in kosmosx_torch (``train/distill.py``) against the
JAX package, on the CPU (fp32, bar 1e-4 as tests/test_torch_parity.py:48;
JAX at matmul precision "highest").

``distill_loss`` at temperatures 1 and 2, with and without a mask, from
one jitted JAX function; one ``make_distill_step`` with JAX's optimizer
(``optax.adamw(lr, weight_decay=0.0)``) on seeded torch inits carried to
JAX with ``to_numpy_params``. Then the port's counterpart of
tests/test_distill.py's end-to-end check, in torch only: a distilled draft
raises speculative acceptance, and speculative tokens stay
``generate_text``'s.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.generate.sampler import SamplingConfig, generate_text
from kosmosx_torch.generate.speculative import speculative_generate
from kosmosx_torch.models.language import KosmosLanguage as TLanguage
from kosmosx_torch.train import distill as tdistill
from kosmosx_torch.train.data import synthetic_text_batches
from kosmosx_torch.train.optim import Optimizer
from kosmosx_torch.utils.jax_params import to_numpy_params
from kosmosx_tpu.train import distill as jdistill

TOL = dict(atol=1e-4, rtol=1e-4)
LR = 1e-3


def _cfg(mod, dim, layers):
    return mod.MagnetoConfig(
        vocab_size=61, embed_dim=dim, ffn_dim=2 * dim, layers=layers, heads=4,
        max_positions=128, multiway=False, dropout=0.0, attention_dropout=0.0,
        use_flash_attention=False, compute_dtype="float32")


TARGET, DRAFT = _cfg(tcfg, 48, 2), _cfg(tcfg, 32, 1)


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


def _inputs():
    rng = np.random.default_rng(0)
    student = rng.standard_normal((2, 6, 13)).astype(np.float32) * 2
    teacher = rng.standard_normal((2, 6, 13)).astype(np.float32) * 2
    teacher[1, 2] = student[1, 2]  # one position agrees
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
    return student, teacher, mask


@pytest.fixture(scope="module")
def jax_losses():
    """JAX's loss and metrics for every (temperature, mask) case, in one
    compiled function."""
    student, teacher, mask = _inputs()

    def cases(s, t, m):
        return {f"{temp}-{masked}": jdistill.distill_loss(
            s, t, m if masked else None, temp)
            for temp in (1.0, 2.0) for masked in (True, False)}

    return jax.tree_util.tree_map(
        np.asarray, jax.jit(cases)(student, teacher, mask))


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("temp", [1.0, 2.0], ids=["T1", "T2"])
def test_distill_loss_matches_jax(jax_losses, temp, masked):
    """Forward KL with the T^2 scale and the masked agreement share."""
    student, teacher, mask = _inputs()
    loss, metrics = tdistill.distill_loss(
        torch.as_tensor(student), torch.as_tensor(teacher),
        torch.as_tensor(mask) if masked else None, temp)
    jloss, jmetrics = jax_losses[f"{temp}-{masked}"]
    np.testing.assert_allclose(loss.item(), jloss, **TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), jmetrics[k], **TOL,
                                   err_msg=k)


def test_distill_step_matches_jax():
    """One ``make_distill_step`` on both sides (teacher frozen, student
    AdamW with optax's adamw defaults, weight decay 0): metrics and every
    student parameter within 1e-4; the teacher untouched."""
    teacher = TLanguage(TARGET, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    student = TLanguage(DRAFT, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    jteacher, jstudent = to_numpy_params(teacher), to_numpy_params(student)
    teacher0 = {n: p.clone() for n, p in teacher.named_parameters()}
    batch = next(synthetic_text_batches(batch_size=4, seq_len=16,
                                        vocab_size=61, seed=2))
    mask = np.ones((4, 16), np.float32)
    mask[2, 10:] = 0

    jopt = optax.adamw(LR, weight_decay=0.0)
    jstep = jdistill.make_distill_step(_cfg(jcfg, 32, 1), _cfg(jcfg, 48, 2),
                                       jopt, temperature=2.0)
    with jax.default_matmul_precision("highest"):
        jstate, jm = jstep({"params": jstudent,
                            "opt_state": jopt.init(jstudent)},
                           jteacher, batch["input_ids"], mask)
    want = _flat(jax.tree_util.tree_map(np.asarray, jstate["params"]))
    student.set_trainable()
    opt = Optimizer(dict(student.named_parameters()), "adamw",
                    lambda count: LR, weight_decay=0.0, beta2=0.999,
                    grad_clip=None)
    step = tdistill.make_distill_step(DRAFT, TARGET, opt, temperature=2.0)
    _, m = step({"params": student, "opt_state": opt}, teacher,
                torch.as_tensor(batch["input_ids"]).long(),
                torch.as_tensor(mask))
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), **TOL,
                                   err_msg=k)
    got = _flat(to_numpy_params(student))
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, **TOL, err_msg=n)
    assert all(torch.equal(p, teacher0[n])
               for n, p in teacher.named_parameters())


def test_distillation_raises_speculative_acceptance():
    """100 steps of ``distill_draft`` (lr 3e-3) from a random teacher:
    agreement above 0.3, greedy speculative acceptance (gamma 3) at least
    0.1 above a fresh draft's with fewer rounds, and both drafts' tokens
    ``generate_text``'s."""
    teacher = TLanguage(TARGET, generator=torch.Generator().manual_seed(0),
                        device="cpu")

    def batches():
        return synthetic_text_batches(batch_size=8, seq_len=32,
                                      vocab_size=61, seed=3)

    # a hundred steps of tiny ops, on one thread: beside parallel test
    # workers, a thread pool per op crowds the machine (70 s against 3)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        draft1, metrics = tdistill.distill_draft(teacher, TARGET, DRAFT,
                                                 batches(), steps=100,
                                                 learning_rate=3e-3, seed=7)
    finally:
        torch.set_num_threads(threads)
    assert metrics["teacher_agreement"] > 0.3
    assert not any(p.requires_grad for p in teacher.parameters())
    draft0 = TLanguage(DRAFT, generator=torch.Generator().manual_seed(7),
                       device="cpu")
    prompt = torch.as_tensor(next(batches())["input_ids"][:2, :8]).long()
    scfg = SamplingConfig(max_new_tokens=16, greedy=True)
    out0, s0 = speculative_generate(teacher, draft0, TARGET, DRAFT, prompt,
                                    scfg, gamma=3)
    out1, s1 = speculative_generate(teacher, draft1, TARGET, DRAFT, prompt,
                                    scfg, gamma=3)
    rate0 = s0["accepted"] / max(s0["proposed"], 1)
    rate1 = s1["accepted"] / max(s1["proposed"], 1)
    assert rate1 > rate0 + 0.1, (rate0, rate1)
    assert s1["rounds"] < s0["rounds"]
    ref = generate_text(teacher, TARGET, prompt, scfg)
    assert torch.equal(out1, ref) and torch.equal(out0, ref)
