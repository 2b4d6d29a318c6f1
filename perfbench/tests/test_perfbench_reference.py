"""The plain float32 reference against the port's CPU path at a tiny size
(2 layers, narrow widths): the forward, one training step's update,
weight-only int8 logits, and prefill then decode through the cache."""

import copy

import pytest
import torch

from perfbench import port, weights
from perfbench.reference import kosmos as ref
from perfbench.tests.perfbench_tiny import CONFIG

SEED = 2 ** 33 + 5


def _inputs(b=2, lt=20):
    g = weights.generator("cpu", SEED, "inputs")
    return (weights.tokens(g, (b, lt), CONFIG["decoder"]["vocab_size"], "cpu"),
            weights.pixels(g, b, CONFIG["vision"]["image_size"], "cpu"))


def test_tree_matches_the_port():
    from kosmosx_torch.models.kosmos import Kosmos

    kcfg = port.kosmos_config(CONFIG)
    init = Kosmos(kcfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    ours = port.build_model(kcfg, weights.make_weights(CONFIG, SEED, "cpu"))
    assert {n: p.shape for n, p in init.named_parameters()} == \
        {n: p.shape for n, p in ours.named_parameters()}


def test_forward():
    flat = weights.make_weights(CONFIG, SEED, "cpu")
    model = port.build_model(port.kosmos_config(CONFIG), dict(flat))
    toks, imgs = _inputs()
    with torch.no_grad():
        got = model.apply(toks, imgs)
        want = ref.logits(ref.prepare(flat, "fp32", 2), CONFIG, toks, imgs,
                          ref.Lin())
    assert got.shape == want.shape == (2, 24, 64)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_training_step():
    from kosmosx_torch.train.trainer import (TrainConfig, Trainer,
                                             kosmos_loss_fn)

    flat = weights.make_weights(CONFIG, SEED, "cpu")
    kcfg = port.kosmos_config(CONFIG)
    model = port.build_model(kcfg, {k: v.clone() for k, v in flat.items()})
    toks, imgs = _inputs()
    batch = {"text_tokens": toks, "images": imgs}
    trainer = Trainer(lambda g: model, kosmos_loss_fn(kcfg),
                      TrainConfig(optimizer="lion", schedule="constant",
                                  warmup_steps=0, learning_rate=1e-3,
                                  freeze=("clip",), prefetch=False,
                                  checkpoint_every=0), device="cpu")
    trainer.init_state()
    logged = []
    trainer.run([batch], log_fn=lambda step, m: logged.append(m["loss"]))

    p = ref.prepare(flat, "fp32", 2)
    leaves = ref.trainable_paths(p)
    opt = ref.Lion(leaves, lr=1e-3, beta1=0.9, beta2=0.95, weight_decay=0.1,
                   clip=1.0)
    loss, grads = ref.loss_and_grads(p, CONFIG, batch, ref.Lin(), leaves)
    opt.step(grads)
    assert logged[0] == pytest.approx(loss, abs=1e-5)
    params = dict(model.named_parameters())
    assert set(leaves) == set(trainer.optimizer.params)
    for name, t in leaves.items():
        torch.testing.assert_close(params[name].detach(), t, rtol=0,
                                   atol=1e-6, msg=name)


def test_w8_logits():
    cfg = dict(copy.deepcopy(CONFIG), weights="w8")
    flat = weights.make_weights(cfg, SEED, "cpu", torch.bfloat16)
    model = port.build_model(port.kosmos_config(cfg), dict(flat))
    toks, imgs = _inputs()
    with torch.no_grad():
        got = model.apply(toks, imgs)
        want = ref.logits(ref.prepare(flat, "w8", 2), cfg, toks, imgs,
                          ref.Lin())
        plain = ref.logits(ref.prepare(flat, "fp32", 2), cfg, toks, imgs,
                           ref.Lin())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert (got - plain).abs().max() > 1e-3   # the codes do change it


@pytest.mark.parametrize("image", [False, True])
def test_prefill_then_decode(image):
    """The engine's greedy tokens, prefilled then decoded through the KV
    cache, are the reference's argmax over the whole sequence."""
    from kosmosx_torch.generate.sampler import SamplingConfig
    from kosmosx_torch.serve.config import ServeConfig
    from kosmosx_torch.serve.engine import ServeEngine

    flat = weights.make_weights(CONFIG, SEED, "cpu")
    kcfg = port.kosmos_config(CONFIG, decode_attn_kernel=True)
    model = port.build_model(kcfg, dict(flat))
    eng = ServeEngine(model, kcfg.decoder,
                      ServeConfig(max_batch=2, max_prompt_len=16, max_len=40),
                      SamplingConfig(greedy=True), kosmos_cfg=kcfg,
                      device="cpu")
    toks, imgs = _inputs(1, 10)
    h = eng.submit(toks[0].tolist(), max_new_tokens=8,
                   images=imgs if image else None)
    eng.run()
    served = h.tokens
    seq = torch.tensor([toks[0].tolist() + served[:-1]])
    with torch.no_grad():
        want = ref.logits(ref.prepare(flat, "fp32", 2), CONFIG, seq,
                          imgs if image else None, ref.Lin())
    first = 9 + (CONFIG["image_embed_len"] if image else 0)
    assert served == want[0, first:].argmax(-1).tolist()
