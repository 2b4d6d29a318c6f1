"""Resuming the JAX package's training checkpoints in kosmosx_torch, on
the CPU.

JAX's ``Trainer`` (and ``LoraTrainer``) trains a 2-layer, 64-wide decoder
(in the list layout, and once in the stacked ``scan_layers`` one) for two
steps and writes its orbax checkpoint (under accumulation 2:
three micro-steps, so the checkpoint holds a nonzero accumulator); JAX
then resumes it for one more step (``cfg.resume``), and so does the
port's ``Trainer`` (``LoraTrainer``) from the same ``output_dir``. The
resumed step's loss and the parameters (factors) after it agree at 1e-4
in fp32 (AdamW8bit's parameters on JAX's fed gradients, see below), the
8-bit moments' codes and scales bit for bit (the global clip stays
inactive, as tests/test_torch_port_train_quant.py holds them), and
every leaf ``read_orbax_tree`` reads equals orbax's restore. The JAX runs
are made once per module; dropout is off.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_worker as w
from kosmosx_torch.models.language import KosmosLanguage
from kosmosx_torch.scripts import train as ttrain_cli
from kosmosx_torch.train import checkpoint as tckpt
from kosmosx_torch.train import lora as tlora
from kosmosx_torch.train import trainer as ttrainer
from kosmosx_torch.utils.jax_params import to_numpy_params
from kosmosx_tpu.parallel.mesh import make_mesh as jmake_mesh
from kosmosx_tpu.train import lora as jlora
from kosmosx_tpu.train import trainer as jtrainer
from test_torch_port_tensor import flat, jax_cfg, jax_train_cfg, path_name
from test_torch_port_train_quant import _j_codes

TOL = dict(rtol=1e-4, atol=1e-4)
SEED = 5
RANK = 4
# a clip no gradient here reaches keeps optax's chain (its empty state) and
# the 8-bit codes bit-identical
GRAD_CLIP = 1e3
# case -> (optimizer, grad_accum, steps before the checkpoint); "adamw"
# runs JAX's stacked (scan_layers) layer layout, the rest the list one
CASES = {"lion": ("lion", 1, 2), "adamw": ("adamw", 1, 2),
         "stable_adamw": ("stable_adamw", 1, 2),
         "adamw8bit": ("adamw8bit", 1, 2), "lion8bit": ("lion8bit", 1, 2),
         "accum2": ("adamw", 2, 3), "lora": ("adamw", 1, 2)}
SCAN = "adamw"


def batches():
    """4 batches of 2 rows x 16 tokens with different right padding."""
    rng = np.random.default_rng(17)
    out = []
    for _ in range(4):
        ids = rng.integers(2, 97, (2, 16)).astype(np.int32)
        mask = np.ones((2, 16), np.int32)
        for row, keep in enumerate(rng.integers(6, 17, 2)):
            mask[row, keep:] = 0
        out.append({"input_ids": np.where(mask > 0, ids, 1).astype(np.int32),
                    "attention_mask": mask})
    return out


def train_cfg(name, accum, out_dir, **kw):
    return ttrainer.TrainConfig(
        optimizer=name, grad_accum=accum, schedule="cosine",
        learning_rate=1e-2, total_steps=10, warmup_steps=1, seed=SEED,
        grad_clip=GRAD_CLIP, log_every=1, checkpoint_every=0, prefetch=False,
        output_dir=str(out_dir), **kw)


def base_model():
    return KosmosLanguage(w.tp_config(), generator=torch.Generator(
        ).manual_seed(SEED), device="cpu")


def jax_run(case, out_dir):
    """JAX's run of ``case``: its checkpoint after ``save`` steps, then
    JAX's resume for one step: (step, loss, params or factors, the 8-bit
    codes by slot) of the resumed step."""
    name, accum, save = CASES[case]
    cfg = jax_cfg(w.tp_config(scan_layers=case == SCAN))
    tc = dataclasses.replace(jax_train_cfg(train_cfg(name, accum, out_dir)),
                             checkpoint_every=save)
    mesh = jmake_mesh(devices=jax.devices()[:1])
    loss_fn = jtrainer.lm_loss_fn(cfg)
    if case == "lora":
        port = tlora.LoraTrainer(None, None, train_cfg(name, accum, out_dir),
                                 RANK, base_params=base_model(),
                                 device="cpu")
        port.init_state()
        factors = {n: p.detach().numpy()
                   for n, p in flat(port.state["lora"]).items()}
        jt = jlora.LoraTrainer(None, loss_fn, tc, RANK, mesh=mesh,
                               base_params=to_numpy_params(port.base_params))
        jt.init_state()
        leaves, tdef = jax.tree_util.tree_flatten_with_path(jt.state["lora"])
        jt.state["lora"] = jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(factors[path_name(p)]) for p, _ in leaves])
        inner = jt._t
    else:
        params = to_numpy_params(base_model())
        if case == SCAN:
            params["layers"] = jax.tree_util.tree_map(
                lambda *xs: np.stack(xs), *params["layers"])
        jt = jtrainer.Trainer(None, loss_fn, tc, mesh=mesh)
        jt.init_state(jax.tree_util.tree_map(jnp.asarray, params))
        inner = jt
    data = batches()
    logs = {}
    fed = None
    with jax.default_matmul_precision("highest"):
        jt.run(iter(data[:save]), log_fn=logs.__setitem__)
        if name.endswith("8bit"):
            # the resumed step's gradients through optax op by op (the
            # jitted update's fusions move a scale by an ulp)
            params = jt.state["params"]
            grads = jax.jit(jax.grad(lambda p, b: loss_fn(p, b, None)[0]))(
                params, jax.tree_util.tree_map(jnp.asarray, data[save]))
            updates, opt = jt.optimizer.update(grads, jt.state["opt_state"],
                                               params)
            fed = dict(grads={k: np.array(v) for k, v in flat(grads).items()},
                       params={k: np.asarray(v) for k, v in flat(
                           optax.apply_updates(params, updates)).items()},
                       codes=_j_codes(opt))
        inner.cfg = dataclasses.replace(tc, resume=True, checkpoint_every=0)
        jt.run(iter(data[:save + 1]), log_fn=logs.__setitem__)
    key = "lora" if case == "lora" else "params"
    tree = jax.tree_util.tree_map(np.asarray, jt.state[key])
    if case == SCAN:
        tree["layers"] = [jax.tree_util.tree_map(lambda x: x[i],
                                                 tree["layers"])
                          for i in range(cfg.layers)]
    return dict(step=save + 1, loss=float(logs[save + 1]["loss"]),
                params=flat(tree), fed=fed)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    return root, {case: jax_run(case, root / case) for case in CASES}


def port_trainer(case, out_dir, name=None):
    """The port's ``Trainer`` (``LoraTrainer``) of ``case`` set to resume
    from ``out_dir``."""
    opt, accum, _ = CASES[case]
    tc = train_cfg(name or opt, accum, out_dir, resume=True)
    cfg = w.tp_config()
    if case == "lora":
        return tlora.LoraTrainer(None, ttrainer.lm_loss_fn(cfg), tc, RANK,
                                 base_params=base_model(), device="cpu")
    return ttrainer.Trainer(
        lambda g: KosmosLanguage(cfg, generator=g, device="cpu"),
        ttrainer.lm_loss_fn(cfg), tc, device="cpu")


def named(state):
    if "lora" in state:
        return {n: t.detach().numpy()
                for n, t in tlora.lora_state_dict(state["lora"]).items()}
    return {n: p.detach().numpy()
            for n, p in state["params"].named_parameters()}


def assert_codes(opt, codes):
    for slot, by_name in codes.items():
        mine = getattr(opt, slot)
        assert sorted(mine) == sorted(by_name)
        for n, qs in by_name.items():
            for part in ("q", "scale"):
                np.testing.assert_array_equal(mine[n][part].numpy(),
                                              np.asarray(qs[part]),
                                              err_msg=f"{slot} {part} {n}")


@pytest.mark.parametrize("case", list(CASES) + ["mismatch"])
def test_resume_continues_the_jax_run(runs, case):
    """The port's ``Trainer.run`` (``LoraTrainer.run``) with
    ``cfg.resume`` on JAX's ``output_dir`` (every ``make_optimizer`` kind
    under the global clip, ``optax.MultiSteps`` saved mid-accumulation, a
    ``LoraTrainer``'s factors, JAX's stacked layer layout) takes JAX's
    resumed step: the loss at 1e-4, and every parameter (factor) after it
    at 1e-4, but for AdamW8bit: its update on a near-zero second moment
    turns the two packages' fp32 gradients' last bits into whole steps
    (``u = m / sqrt(v)`` with ``v``'s code 0), so its parameters after the
    step are held on JAX's own gradients of that step fed to the resumed
    optimizer and to optax (op by op, as tests/test_torch_port_train_quant.py
    holds them) at 1e-6. Both 8-bit kinds' codes and scales after that fed
    step are equal to optax's. A checkpoint of another optimizer raises,
    naming both."""
    root, jax_runs = runs
    if case == "mismatch":
        with pytest.raises(ValueError, match="optimizer is lion, the run's "
                                             "is adamw"):
            port_trainer("lion", root / "lion", name="adamw").run(batches())
        return
    want = jax_runs[case]
    step = want["step"]
    t = port_trainer(case, root / case)
    logs = {}
    state, _ = t.run(batches()[:step], log_fn=logs.__setitem__)
    assert sorted(logs) == [step] and state["step"] == step
    np.testing.assert_allclose(logs[step]["loss"], want["loss"], **TOL)
    got = named(state)
    assert sorted(got) == sorted(want["params"])
    if CASES[case][1] > 1:
        assert state["opt_state"].mini_step == 0
        assert state["opt_state"].gradient_step == 2
    if case != "adamw8bit":
        for n, v in want["params"].items():
            np.testing.assert_allclose(got[n], v, **TOL, err_msg=n)
    if want["fed"] is None:
        return
    fed = want["fed"]
    t = port_trainer(case, root / case)
    t.init_state()
    path, _ = tckpt.latest_checkpoint(str(root / case))
    state = tckpt.restore_checkpoint(path, t.state)
    state["opt_state"].step({n: torch.from_numpy(g)
                             for n, g in fed["grads"].items()})
    for n, v in named(state).items():
        np.testing.assert_allclose(v, fed["params"][n], rtol=1e-6,
                                   atol=1e-6, err_msg=n)
    assert_codes(state["opt_state"], fed["codes"])


@pytest.mark.parametrize("per_layer", [512, 320])
def test_stacked_8bit_moments_split_per_layer(per_layer):
    """JAX's stacked (``scan_layers``) layout keeps one 8-bit moment per
    stacked leaf, its blocks running over the whole (L, ...) stack: the
    port's walk of optax's state gives each layer the codes and scales
    JAX's quantizer gives that layer alone, and raises where a layer's
    elements do not fill whole blocks."""
    from kosmosx_tpu.train.quant import quantize_blockwise

    x = np.random.default_rng(3).standard_normal((3, per_layer)).astype(
        np.float32)
    moment = {"layers": {"ln": {"g": {
        k: np.asarray(v) for k, v in quantize_blockwise(x).items()}}}}
    numel = {f"layers.{i}.ln.g": per_layer for i in range(3)}
    if per_layer % 256:
        with pytest.raises(ValueError, match="across layer boundaries"):
            tckpt._codes(moment, "q", numel)
        return
    for part in ("q", "scale"):
        got = tckpt._by_name(tckpt._codes(moment, part, numel))
        assert sorted(got) == sorted(numel)
        for i in range(3):
            np.testing.assert_array_equal(
                got[f"layers.{i}.ln.g"].numpy(),
                np.asarray(quantize_blockwise(x[i])[part]), err_msg=part)


def test_read_orbax_tree_reads_a_whole_trainer_checkpoint(runs):
    """``read_orbax_tree`` reads every subtree of a JAX ``Trainer``
    checkpoint (params, optax's state under ``MultiSteps`` with its empty
    states as None, step, rng), each leaf equal to orbax's restore."""
    import orbax.checkpoint as ocp

    root, _ = runs
    path = str(root / "accum2" / "step_3")
    mine = tckpt.read_orbax_tree(path)
    assert sorted(mine) == ["opt_state", "params", "rng", "step"]
    assert mine["opt_state"]["inner_opt_state"][0] is None
    want = ocp.StandardCheckpointer().restore(path)

    def leaves(tree):
        return {path_name(p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    got, ref = leaves(mine), leaves(want)
    assert sorted(got) == sorted(ref)
    for n, v in ref.items():
        np.testing.assert_array_equal(got[n], v, err_msg=n)
    assert int(tckpt.read_orbax_tree(path, "step")) == 3


def test_train_cli_resumes_a_jax_run(runs, tmp_path):
    """The training CLI's ``--resume`` on a JAX run's output directory (the
    Lion case's step-2 checkpoint, its model given by the CLI's flags)
    continues with steps 3-4 (dropout runs at the config's 0.1 in the CLI,
    so the losses are the port's own; ``test_resume_continues_the_jax_run``
    holds the resumed step against JAX's) and writes its own checkpoint
    beside JAX's; with another ``--optimizer`` it refuses, naming both."""
    root, _ = runs
    shutil.copytree(root / "lion" / "step_2", tmp_path / "run" / "step_2")
    tokens = np.random.default_rng(8).integers(4, 97, 4000).astype(np.uint16)
    np.save(tmp_path / "tokens.npy", tokens)
    cfg = w.tp_config()
    argv = ["--layers", str(cfg.layers), "--dim", str(cfg.embed_dim),
            "--ffn-dim", str(cfg.ffn_dim), "--heads", str(cfg.heads),
            "--vocab-size", str(cfg.vocab_size), "--max-positions",
            str(cfg.max_positions), "--device", "cpu", "--pretokenized",
            str(tmp_path / "tokens.npy"), "--seq-len", "32",
            "--batch-size", "2", "--optimizer", "lion", "--steps", "2",
            "--checkpoint-every", "2", "--log-every", "1", "--no-final-save",
            "--resume", "--output-dir", str(tmp_path / "run")]
    jsonl = tmp_path / "m.jsonl"
    assert ttrain_cli.main(argv + ["--metrics-jsonl", str(jsonl)]) == 0
    recs = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    assert [r["step"] for r in recs] == [3, 4]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert (tmp_path / "run" / "step_4" / "state.pt").exists()
    shutil.rmtree(tmp_path / "run" / "step_4")
    with pytest.raises(ValueError, match="optimizer is lion, the run's is "
                                         "adamw"):
        ttrain_cli.main([a if a != "lion" else "adamw" for a in argv])
