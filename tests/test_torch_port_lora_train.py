"""LoRA and QLoRA training in kosmosx_torch against the JAX package, on
the CPU (fp32, bar 1e-4 as tests/test_torch_parity.py:48; JAX at matmul
precision "highest").

JAX's factors (``b`` randomized, so every factor takes a gradient) carry
across with ``from_jax_params``, as tests/test_torch_port_lora.py does.
The JAX side of ``make_lora_train_step`` is its arithmetic with the
gradient function compiled once per base (dense, W8): ``value_and_grad``
over the lora tree, the optax update, ``global_norm`` before it. The W8
operator (``ops/quant_matmul.w8_product``), the one autograd sees on the
card, is checked on the CPU against ``w8_matmul_plain``'s autograd, and
"dots" remat saves it. ``LoraTrainer.run`` on a tiny multimodal Kosmos
runs against JAX's ``LoraTrainer`` (one-device mesh), then merges and
resumes in a fresh trainer. The training CLI's ``--lora-rank`` writes an
adapter the serving CLI loads.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.models.kosmos import Kosmos as TKosmos
from kosmosx_torch.models.language import KosmosLanguage as TLanguage
from kosmosx_torch.nn import decoder as tdec
from kosmosx_torch.ops import quant_matmul as qm
from kosmosx_torch.scripts import serve as tserve_cli
from kosmosx_torch.scripts import train as ttrain_cli
from kosmosx_torch.train import checkpoint as tckpt
from kosmosx_torch.train import lora as tlora
from kosmosx_torch.train import optim as toptim
from kosmosx_torch.train import trainer as ttrainer
from kosmosx_torch.utils.jax_params import from_jax_params, to_numpy_params
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.parallel.mesh import make_mesh
from kosmosx_tpu.train import lora as jlora
from kosmosx_tpu.train import trainer as jtrainer
from kosmosx_tpu.utils.quantize import quantize_params_w8 as jquantize
from test_torch_port_model import dec_cfg, kosmos_cfg

TOL = dict(atol=1e-4, rtol=1e-4)
LR = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {n: t.detach().numpy() for n, t in
            tlora.lora_state_dict(tree).items()}


def _port_lora(jtree):
    return from_jax_params(_np_tree(jtree), "cpu")


# ---------------------------------------------------------------------------
# the W8 product under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
def test_w8_product_dx_matches_plain(stacked, dtype):
    """The operator's output and ``dx = (dy * scale) @ q^T`` equal
    ``w8_matmul_plain`` and its autograd gradient; codes, scales and the
    layer index take none."""
    g = torch.Generator().manual_seed(0)
    k, n = 48, 40
    q = torch.randint(-127, 128, (3, k, n) if stacked else (k, n),
                      generator=g, dtype=torch.int8)
    scale = torch.rand((3, 1, n) if stacked else (1, n), generator=g) / 100
    layer = torch.tensor(2, dtype=torch.int32) if stacked else None
    x = torch.randn(6, k, generator=g).to(dtype).requires_grad_()
    dy = torch.randn(6, n, generator=g).to(dtype)
    y = qm.w8_product(x, q, scale, layer)
    assert y.grad_fn is not None
    dx, = torch.autograd.grad(y, x, dy)
    x2 = x.detach().clone().requires_grad_()
    ref = qm.w8_matmul_plain(x2, q[2] if stacked else q,
                             scale[2] if stacked else scale)
    dx_ref, = torch.autograd.grad(ref, x2, dy)
    assert y.dtype == dx.dtype == dtype
    assert torch.equal(y, ref) and torch.equal(dx, dx_ref)


@pytest.mark.parametrize("policy,runs", [("dots", 1), ("dots_no_batch", 1),
                                         ("nothing", 2)])
def test_remat_saves_the_w8_product(policy, runs, monkeypatch):
    """Under a checkpointed region, "dots" and "dots_no_batch" keep the W8
    operator's output (one forward run), "nothing" runs it again in the
    backward; the gradient is the same."""
    calls = []
    plain = qm.w8_matmul_plain
    monkeypatch.setattr(qm, "w8_matmul_plain",
                        lambda *a: calls.append(1) or plain(*a))
    g = torch.Generator().manual_seed(1)
    q = torch.randint(-127, 128, (16, 8), generator=g, dtype=torch.int8)
    scale = torch.rand(1, 8, generator=g)
    x = torch.randn(4, 16, generator=g, requires_grad=True)

    def region(x):
        return qm.w8_product(x, q, scale, None).sin()

    out = checkpoint(region, x, use_reentrant=False,
                     context_fn=tdec._REMAT_CONTEXTS[policy])
    dx, = torch.autograd.grad(out.sum(), x)
    assert len(calls) == runs
    x2 = x.detach().requires_grad_()
    want, = torch.autograd.grad(region(x2).sum(), x2)
    assert torch.equal(dx, want)


def test_set_trainable_keeps_codes_frozen():
    """A W8 tree: full-parameter training raises naming LoRA; with its
    top-level keys frozen it trains nothing and raises nothing."""
    cfg = dataclasses.replace(dec_cfg(tcfg), scan_layers=True)
    from kosmosx_torch.utils.quantize import quantize_params_w8

    model = quantize_params_w8(TLanguage(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
        min_size=1)
    with pytest.raises(ValueError, match="LoRA"):
        model.set_trainable()
    model.set_trainable(tuple(model._modules))
    assert not any(p.requires_grad for p in model.parameters())


# ---------------------------------------------------------------------------
# make_lora_train_step against JAX, dense and W8 bases
# ---------------------------------------------------------------------------


def _jax_tree(model):
    """A port model's parameters as the JAX tree (numpy leaves, list
    layers): a seeded torch init is cheaper than a JAX one."""
    return to_numpy_params(model)


def _stack_layers(tree):
    """The list layer layout -> JAX's stacked one (``scan_layers``)."""
    return {**tree, "layers": jax.tree_util.tree_map(
        lambda *xs: np.stack(xs), *tree["layers"])}


@pytest.fixture(scope="module", params=["dense", "w8"])
def lora_pair(request):
    """A tiny decoder (list layers dense; stacked and W8 for QLoRA) on
    both sides, rank-3 factors in JAX's layout (``a`` ~ N(0, 1/3), ``b``
    ~ N(0, 0.01), scale 1) from numpy, a batch with padding in row 1, and
    JAX's gradient of the LM loss over the lora tree, compiled once."""
    w8 = request.param == "w8"
    jc = dec_cfg(jcfg, scan_layers=w8)
    tc = dec_cfg(tcfg, scan_layers=w8)
    params = _jax_tree(TLanguage(dec_cfg(tcfg), device="cpu",
                                 generator=torch.Generator().manual_seed(0)))
    if w8:
        with jax.default_matmul_precision("highest"):
            params = _stack_layers(_np_tree(jax.jit(
                lambda p: jquantize(p, min_size=64))(params)))
    shapes = jax.eval_shape(lambda: jlora.strip_lora(jlora.add_lora(
        jax.random.PRNGKey(0), params, rank=3))[1])
    rng = np.random.default_rng(3)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, s: {"a": rng.standard_normal(s.shape) / np.sqrt(3),
                      "b": rng.standard_normal(s.shape) * 0.1,
                      "scale": np.ones(s.shape)}[p[-1].key].astype(np.float32),
        shapes)
    base = jlora.strip_lora(params)[0]
    batch = {"input_ids": rng.integers(4, 97, (2, 24)).astype(np.int32),
             "attention_mask": np.ones((2, 24), np.int32)}
    batch["attention_mask"][1, 19:] = 0
    loss_fn = jtrainer.lm_loss_fn(jc)
    grad = jax.jit(jax.value_and_grad(
        lambda lt, b, bt: loss_fn(jlora.attach_lora(b, lt), bt, None),
        has_aux=True))
    return jc, tc, base, lora, batch, grad


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_lora_steps_match_jax(lora_pair, opt):
    """Three steps of ``make_lora_train_step`` with optax's ``adam`` and
    ``adamw`` (decay on every leaf, optax's default mask): losses, gradient
    norms and every factor (``a``, ``b`` and ``scale``) within 1e-4; the
    base, W8 codes and scales included, bit-identical; optimizer state
    for the factors only."""
    jc, tc, jbase, jl, batch, grad = lora_pair
    jopt = optax.adam(LR) if opt == "adam" else optax.adamw(LR)
    jstate, lora_j = jopt.init(jl), jl
    want = []
    with jax.default_matmul_precision("highest"):
        for _ in range(3):
            (loss, _), g = grad(lora_j, jbase, batch)
            updates, jstate = jopt.update(g, jstate, lora_j)
            lora_j = optax.apply_updates(lora_j, updates)
            want.append((float(loss), float(optax.global_norm(g))))

    base = TLanguage(tc, params=from_jax_params(_np_tree(jbase), "cpu"))
    base0 = {n: p.clone() for n, p in base.named_parameters()}
    decay = 1e-4 if opt == "adamw" else 0.0

    def make_opt(p):
        return toptim.Optimizer(p, "adamw", lambda count: LR,
                                weight_decay=decay, beta2=0.999,
                                grad_clip=None, mask={n: True for n in p})

    state = tlora.lora_state(_port_lora(jl), make_opt, None)
    step = tlora.make_lora_train_step(ttrainer.lm_loss_fn(tc),
                                      state["opt_state"])
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    got = []
    for _ in range(3):
        state, m = step(state, base, tbatch)
        got.append((m["loss"].item(), m["grad_norm"].item()))
    np.testing.assert_allclose(got, want, **TOL)
    assert state["step"] == 3
    tf, jf = _flat(state["lora"]), _flat(_port_lora(lora_j))
    assert sorted(tf) == sorted(jf)
    for n in jf:
        np.testing.assert_allclose(tf[n], jf[n], **TOL, err_msg=n)
    for n, p in base.named_parameters():
        assert not p.requires_grad and torch.equal(p, base0[n]), n
    opt_ = state["opt_state"]
    assert set(opt_.params) == set(tf)
    assert opt_.moment_bytes() == 2 * sum(a.nbytes for a in tf.values())


# ---------------------------------------------------------------------------
# LoraTrainer.run on a tiny Kosmos against JAX's LoraTrainer
# ---------------------------------------------------------------------------


def _kosmos_batches(n):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        toks = rng.integers(4, 97, (2, 24)).astype(np.int32)
        toks[:, 0] = 0
        toks[1, 20:] = 1
        out.append({"text_tokens": toks,
                    "images": rng.random((2, 3, 28, 28)).astype(np.float32)})
    return out


def test_lora_trainer_run_merge_and_resume_match_jax(tmp_path):
    """Four AdamW steps of ``LoraTrainer.run`` (CLIP frozen in the config,
    which does not reach the factors: the ViT's are trained too) from
    JAX's initial factors: losses and factors within 1e-4 of JAX's
    ``LoraTrainer``; the merged model's logits equal the adapted model's
    and JAX's merged parameters; ``evaluate`` on the adapted model; a fresh
    trainer resumed from step 2 ends bit-identical."""
    cj, ct = kosmos_cfg(jcfg), kosmos_cfg(tcfg)
    params = _jax_tree(TKosmos(ct, device="cpu",
                               generator=torch.Generator().manual_seed(5)))
    batches = _kosmos_batches(4)
    kw = dict(batch_size=2, learning_rate=1e-2, optimizer="adamw",
              schedule="constant", warmup_steps=1, total_steps=10,
              log_every=1, freeze=("clip",), prefetch=False)
    jt = jlora.LoraTrainer(lambda k: JKosmos.init(k, cj),
                           jtrainer.kosmos_loss_fn(cj),
                           jtrainer.TrainConfig(checkpoint_every=0, **kw),
                           rank=2, mesh=make_mesh(devices=jax.devices()[:1]),
                           base_params=params)
    jt.init_state()
    jl0 = _port_lora(jt.state["lora"])
    jlogs = {}
    with jax.default_matmul_precision("highest"):
        jt.run(iter(batches), log_fn=jlogs.__setitem__)
        jmerged = _np_tree(jt.merged_params())

    def port(resume=False):
        t = tlora.LoraTrainer(
            None, ttrainer.kosmos_loss_fn(ct),
            ttrainer.TrainConfig(checkpoint_every=2, output_dir=str(tmp_path),
                                 resume=resume, **kw), rank=2, device="cpu",
            base_params=TKosmos(ct, params=from_jax_params(_np_tree(params))))
        t.init_state()
        with torch.no_grad():
            for n, p in tlora.lora_state_dict(t.state["lora"]).items():
                p.copy_(tlora.lora_state_dict(jl0)[n])
        return t

    tt = port()
    tlogs = {}
    tt.run(iter(batches), log_fn=tlogs.__setitem__)
    assert sorted(tlogs) == sorted(jlogs) == [1, 2, 3, 4]
    np.testing.assert_allclose([tlogs[s]["loss"] for s in range(1, 5)],
                               [jlogs[s]["loss"] for s in range(1, 5)], **TOL)
    tf, jf = _flat(tt.state["lora"]), _flat(_port_lora(jt.state["lora"]))
    assert sorted(tf) == sorted(jf) and any(".clip." in f".{n}" for n in tf)
    for n in jf:
        np.testing.assert_allclose(tf[n], jf[n], **TOL, err_msg=n)
    assert not any(p.requires_grad for p in tt.base_params.parameters())

    toks = torch.as_tensor(batches[0]["text_tokens"])
    imgs = torch.as_tensor(batches[0]["images"])
    merged = tt.merged_params()
    with torch.no_grad():
        adapted = tt.adapted_params().apply(toks, imgs)
        np.testing.assert_allclose(merged.apply(toks, imgs).numpy(),
                                   adapted.numpy(), **TOL)
    want = {n: p.numpy() for n, p in TKosmos(
        ct, params=from_jax_params(jmerged)).named_parameters()}
    for n, p in merged.named_parameters():
        np.testing.assert_allclose(p.numpy(), want[n], **TOL, err_msg=n)
    ev = tt.evaluate([batches[0]])
    assert np.isfinite(ev["eval_loss"])

    import shutil
    shutil.rmtree(tmp_path / "step_4")
    again = port(resume=True)
    steps = []
    again.run(iter(batches), log_fn=lambda s, m: steps.append(s))
    assert steps == [3, 4] and again.state["step"] == 4
    for n, a in _flat(again.state["lora"]).items():
        np.testing.assert_array_equal(a, tf[n], err_msg=n)
    mu = again.state["opt_state"].mu
    for n, m in tt.state["opt_state"].mu.items():
        assert torch.equal(mu[n], m), n


def _lm_lora_trainer(**kw):
    cfg = dec_cfg(tcfg, **kw.pop("model", {}))
    tc = ttrainer.TrainConfig(batch_size=2, learning_rate=1e-2,
                              optimizer="adamw", schedule="constant",
                              warmup_steps=1, total_steps=10,
                              checkpoint_every=0, log_every=1, **kw)
    return tlora.LoraTrainer(
        lambda g: TLanguage(cfg, generator=g, device="cpu"),
        ttrainer.lm_loss_fn(cfg), tc, rank=2, device="cpu")


def _lm_batches(n):
    rng = np.random.default_rng(8)
    return [{"input_ids": rng.integers(4, 97, (2, 16)).astype(np.int32)}
            for _ in range(n)]


def test_lora_trainer_accumulates_through_multisteps():
    """``grad_accum=2`` goes through ``MultiSteps``: two micro-steps on the
    same batch are one update on it, so [b, b, c, c] at accumulation 2
    ends bit-identical to [b, c] without; the moments are the factors'."""
    b, c = _lm_batches(2)
    accum = _lm_lora_trainer(grad_accum=2)
    accum.run(iter([b, b, c, c]))
    plain = _lm_lora_trainer()
    plain.run(iter([b, c]))
    assert isinstance(accum.optimizer, toptim.MultiSteps)
    assert accum.state["step"] == 4 and plain.state["step"] == 2
    for n, a in _flat(accum.state["lora"]).items():
        np.testing.assert_array_equal(a, _flat(plain.state["lora"])[n],
                                      err_msg=n)
    assert accum.optimizer.moment_bytes() == plain.optimizer.moment_bytes()


def test_lora_dropout_keys_come_from_the_state_generator():
    """With dropout 0.1 each step draws its key from the state's generator:
    two trainers of one seed end bit-identical, their generators advanced
    alike; the base is the same module, frozen, and never written."""
    kw = dict(model=dict(dropout=0.1, attention_dropout=0.1))
    runs = []
    for _ in range(2):
        t = _lm_lora_trainer(**kw)
        t.run(iter(_lm_batches(3)))
        runs.append(t)
    a, b = runs
    assert torch.equal(a.state["rng"].get_state(), b.state["rng"].get_state())
    assert not torch.equal(a.state["rng"].get_state(), torch.Generator()
                           .manual_seed(a.cfg.seed).get_state())
    for n, x in _flat(a.state["lora"]).items():
        np.testing.assert_array_equal(x, _flat(b.state["lora"])[n], err_msg=n)
    assert not any(p.requires_grad for p in a.base_params.parameters())


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

TINY = ["--layers", "2", "--dim", "32", "--ffn-dim", "64", "--heads", "4",
        "--device", "cpu"]


def test_lora_cli_adapter_loads_in_the_serving_cli(tmp_path, capsys):
    """``--lora-rank 4`` trains factors only, checkpoints them, writes
    ``{output-dir}/adapter`` (the factors) and a merged ``final``; the
    serving CLI serves a prompt through that adapter."""
    out = tmp_path / "run"
    assert ttrain_cli.main(TINY + [
        "--synthetic", "--seq-len", "16", "--steps", "3", "--lora-rank", "4",
        "--lora-alpha", "8", "--lora-targets", "q,v", "--optimizer", "adamw",
        "--checkpoint-every", "3", "--output-dir", str(out)]) == 0
    adapter = tckpt.restore_params(str(out / "adapter"))
    assert adapter and all(".lora." in n and n.split(".")[-4] in ("q", "v")
                           for n in adapter)
    assert "lora" in torch.load(out / "step_3" / tckpt.STATE_FILE,
                                weights_only=True)
    final = tckpt.restore_params(str(out / "final"))
    assert not any(".lora." in n for n in final)
    capsys.readouterr()
    assert tserve_cli.main(TINY + [
        "--max-positions", "130", "--dtype", "float32", "--no-flash",
        "--slots", "2", "--prompt", "a b c", "--max-new-tokens", "4",
        "--adapter", f"a={out / 'adapter'}", "--use-adapter", "a"]) == 0
    assert "[req 0]" in capsys.readouterr().out
