"""Dropout and the remat policies of kosmosx_torch on the CPU.

JAX's random bits cannot be matched, so dropout is held to its
definition: the keep rate within 5 binomial standard deviations of
``1 - rate``, the kept values scaled by ``1 / (1 - rate)`` so the mean is
preserved (5 deviations again), the identity without a key or at rate 0.
Attention dropout takes the plain path, as in JAX (a spy counts no flash
call). Under dropout the gradients with remat ("nothing", "dots",
"dots_no_batch") are bit-identical to those without (the recomputed layer
draws its masks from the same integer keys), and a generator restored from
its state gives the same masks again. ``dots_no_batch`` recomputes
attention's batched products (``bmm``) in the backward and no projection
(``mm``): an op-count probe of the backward against no remat.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import kosmosx_torch.core.config as tcfg
from kosmosx_torch.core.params import ParamTree
from kosmosx_torch.models.language import KosmosLanguage
from kosmosx_torch.nn import attention as tattn
from kosmosx_torch.nn import layers
from kosmosx_torch.train import data as tdata
from kosmosx_torch.train import trainer as ttrainer


def _cfg(**kw):
    base = dict(vocab_size=97, embed_dim=32, ffn_dim=64, layers=2, heads=4,
                max_positions=512, compute_dtype="float32", dropout=0.1,
                attention_dropout=0.1, activation_dropout=0.1)
    base.update(kw)
    return tcfg.MagnetoConfig(**base)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_mean(rate):
    n = 200_000
    x = torch.full((n,), 3.0)
    y = layers.dropout(x, rate, 1)
    keep = 1.0 - rate
    kept = int((y != 0).sum())
    sigma = (n * keep * rate) ** 0.5
    assert abs(kept - n * keep) < 5 * sigma
    assert torch.allclose(y[y != 0], torch.tensor(3.0 / keep))
    assert abs(float(y.mean()) - 3.0) < 5 * 3.0 / keep * sigma / n


def test_dropout_is_the_identity_without_a_key_or_rate():
    x = torch.randn(4, 5)
    assert layers.dropout(x, 0.1, None) is x
    assert layers.dropout(x, 0.0, 7) is x


def test_dropout_masks_are_functions_of_the_key():
    x = torch.ones(64, 64)
    a, b = layers.dropout(x, 0.3, 11), layers.dropout(x, 0.3, 11)
    assert torch.equal(a, b)
    assert not torch.equal(a, layers.dropout(x, 0.3, 12))
    assert layers.fold_in(11, 0) != layers.fold_in(11, 1)
    assert layers.fold_in(None, 3) is None


@pytest.mark.parametrize("attn_dropout,flash_calls", [(0.1, 0), (0.0, 1)])
def test_attention_dropout_takes_the_plain_path(monkeypatch, attn_dropout,
                                                flash_calls):
    """At 256 positions attention runs the flash kernel's wrapper unless
    attention dropout runs under a key, as kosmosx_tpu/nn/attention.py:
    314-315 rules."""
    calls = []
    real = tattn.flash_attention

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    params = ParamTree(tattn.init_self_attention(
        torch.Generator().manual_seed(0), 32, 4))
    x = torch.randn(1, 256, 32, generator=torch.Generator().manual_seed(1))
    out = tattn.self_attention(params, x, heads=4, attn_dropout=attn_dropout,
                               rng=layers.rng_key(torch.Generator()))
    assert len(calls) == flash_calls and out.shape == x.shape


@pytest.fixture(scope="module")
def lm_batch():
    return tdata.to_device(next(tdata.synthetic_text_batches(
        batch_size=2, seq_len=24, vocab_size=97)), "cpu")


def _grads(model, cfg, batch, seed):
    model.config = cfg
    return ttrainer.value_and_grad(ttrainer.lm_loss_fn(cfg), model, batch,
                                   torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_dropout_gradients_equal_with_and_without_remat(policy, lm_batch):
    """Residual, activation and attention dropout at 0.1: the loss and
    every gradient with remat bit-identical to no remat, and another seed
    gives another loss."""
    cfg = _cfg()
    model = KosmosLanguage(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    (loss0, _), grads0 = _grads(model, cfg, lm_batch, 5)
    (loss, _), grads = _grads(
        model, dataclasses.replace(cfg, remat=True, remat_policy=policy),
        lm_batch, 5)
    assert torch.equal(loss, loss0)
    for n, g in grads.items():
        assert (g is None) == (grads0[n] is None), n
        assert g is None or torch.equal(g, grads0[n]), n
    (other, _), _ = _grads(model, cfg, lm_batch, 6)
    assert not torch.equal(other, loss0)


def test_restored_generator_gives_the_same_masks(lm_batch):
    """A generator set to a saved state gives the step's key, and so its
    masks, again; the advanced one gives others (a fresh key every step)."""
    cfg = _cfg()
    model = KosmosLanguage(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    g = torch.Generator().manual_seed(9)
    saved = g.get_state()
    first = model.apply(lm_batch["input_ids"], rng=layers.rng_key(g))
    again = torch.Generator()
    again.set_state(saved)
    assert torch.equal(
        model.apply(lm_batch["input_ids"], rng=layers.rng_key(again)), first)
    assert not torch.equal(
        model.apply(lm_batch["input_ids"], rng=layers.rng_key(g)), first)
    plain = dataclasses.replace(cfg, dropout=0.0, attention_dropout=0.0,
                                activation_dropout=0.0)
    model.config = plain
    assert torch.equal(model.apply(lm_batch["input_ids"],
                                   rng=layers.rng_key(g)),
                       model.apply(lm_batch["input_ids"]))


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(model, cfg, batch):
    model.config = cfg
    model.set_trainable(())
    loss, _ = ttrainer.lm_loss_fn(cfg)(model, batch, None)
    with _OpCount() as counter:
        loss.backward()
    model.zero_grad(set_to_none=True)
    return counter.counts


def test_dots_no_batch_recomputes_bmm_and_no_mm(lm_batch):
    """The backward under ``dots_no_batch`` runs as many ``mm``s as without
    remat (no projection is recomputed) and more ``bmm``s (attention's
    batched products are); ``dots`` recomputes neither, ``nothing`` both."""
    cfg = _cfg(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    model = KosmosLanguage(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    base = _backward_ops(model, cfg, lm_batch)
    ops = {p: _backward_ops(model, dataclasses.replace(
        cfg, remat=True, remat_policy=p), lm_batch)
        for p in ("nothing", "dots", "dots_no_batch")}
    assert ops["dots_no_batch"]["mm"] == base["mm"]
    assert ops["dots_no_batch"]["bmm"] > base["bmm"]
    assert ops["dots"]["mm"] == base["mm"] and ops["dots"]["bmm"] == base["bmm"]
    assert ops["nothing"]["mm"] > base["mm"]
    assert ops["nothing"]["bmm"] > base["bmm"]
