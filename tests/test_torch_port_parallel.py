"""kosmosx_torch's data parallelism and ZeRO (FSDP2) training against
kosmosx_tpu on the CPU, the sharding rules, checkpoints across process
counts and the training CLI's ``--distributed``.

The multi-rank cases run once per module in four gloo processes
(``torch_dist_worker.py``'s ``trainer`` task). First AdamW8bit and
Lion8bit over leaves sharded four ways (shard boundaries inside the
256-element blocks, an empty shard), fed the same gradients as optax:
codes and scales bit-identical to JAX's. Then ranks 0-1 train at
``data=2`` and ranks 2-3 at ``fsdp=2`` side by side, with Lion, AdamW and
AdamW8bit, and all four at ``data=2 x fsdp=2`` with Lion and AdamW; each
is held after two steps, on batches whose rows carry different padding,
against JAX's train step on one device over the same global batches
(``Trainer``'s step: the global mean loss) at 1e-4: losses, gradient
norms and parameters. AdamW8bit's parameters are left out there: the
ranks' gradients differ from one process's in the last bits, and where a
second moment sits near the boundary of its lowest code, one code up or
down moves ``m / (sqrt(v) + eps)`` by a whole step; JAX's and the port's
single-process runs differ so too. The ``fsdp=2`` runs checkpoint after
each step; one process resumes from step 1.
"""

import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
import torch_dist_worker as w
from kosmosx_torch.models.kosmos import Kosmos as TKosmos
from kosmosx_torch.models.language import KosmosLanguage
from kosmosx_torch.core.params import to_tree
from kosmosx_torch.parallel import mesh as tmesh
from kosmosx_torch.parallel import sharding as tsh
from kosmosx_torch.train import checkpoint as tckpt
from kosmosx_torch.train import lora as tlora
from kosmosx_torch.train import trainer as ttrainer
from kosmosx_torch.utils.jax_params import to_numpy_params
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.nn import decoder as jdec
from kosmosx_tpu.parallel import sharding as jsh
from kosmosx_tpu.train import checkpoint as jckpt
from kosmosx_tpu.train import optim as joptim
from kosmosx_tpu.train import trainer as jtrainer
from test_torch_port_model import kosmos_cfg
from test_torch_port_train_quant import _j_codes

TOL = dict(rtol=1e-4, atol=1e-4)


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


def _jax_cfg(cfg_t):
    return jcfg.MagnetoConfig(**{f.name: getattr(cfg_t, f.name) for f in
                                 dataclasses.fields(jcfg.MagnetoConfig)})


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The ``trainer`` task's four ranks, started before the JAX references
    are computed so that both run at once."""
    out = tmp_path_factory.mktemp("trainer")
    return out, w.start("trainer", 4, str(out))


@pytest.fixture(scope="module")
def ranks(launched, jax_runs):
    """The ``trainer`` task's results, one dict a rank."""
    out, procs = launched
    outs = w.finish(procs)
    for rank, (rc, stdout, stderr) in enumerate(outs):
        assert rc == 0 and f"RANK{rank} OK" in stdout, (rank, stderr[-3000:])
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def jax_runs(launched):
    """JAX's step on one device over the global batches, per optimizer:
    (losses, grad norms, params by name)."""
    cfg_t = w.train_config()
    model = KosmosLanguage(cfg_t, generator=torch.Generator().manual_seed(
        w.TRAIN_SEED), device="cpu")
    params0 = jax.tree_util.tree_map(jnp.asarray, to_numpy_params(model))
    cfg = _jax_cfg(cfg_t)
    runs = {}
    for name in w.TRAIN_OPTS:
        tc = w.train_cfg(name)
        sched = joptim.make_schedule(tc.schedule, tc.learning_rate,
                                     tc.total_steps, tc.warmup_steps)
        opt = joptim.make_optimizer(tc.optimizer, sched,
                                    weight_decay=tc.weight_decay,
                                    beta1=tc.beta1, beta2=tc.beta2,
                                    grad_clip=tc.grad_clip)
        step = jax.jit(jtrainer.make_train_step(jtrainer.lm_loss_fn(cfg), opt))
        state = {"params": params0, "opt_state": opt.init(params0),
                 "step": jnp.zeros([], jnp.int32), "rng": jax.random.PRNGKey(0)}
        losses, norms = [], []
        with jax.default_matmul_precision("highest"):
            for i, batch in enumerate(w.train_batches()):
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                if name == "lion" and i == 0:   # the ranks resume it
                    jckpt.save_checkpoint(state, str(launched[0] / "jax_lion"),
                                          1)
        params = {k: np.asarray(v) for k, v in _flat(state["params"]).items()}
        runs[name] = (losses, norms, params)
    return runs


CASES = [(kind, name, rank) for kind, rank in (("data2", 0), ("fsdp2", 2))
         for name in w.TRAIN_OPTS] + [("hsdp", "lion", 0), ("hsdp", "adamw", 0)]


@pytest.mark.parametrize("kind,name,rank", CASES,
                         ids=[f"{k}-{n}" for k, n, _ in CASES])
def test_trainer_over_a_mesh_matches_jax(ranks, jax_runs, kind, name, rank):
    _, got = ranks
    got = got[rank]
    losses, norms, params = jax_runs[name]
    pre = f"{kind}.{name}."
    for step in range(1, w.TRAIN_STEPS + 1):
        np.testing.assert_allclose(got[f"{pre}loss{step}"], losses[step - 1],
                                   **TOL, err_msg=f"loss {step}")
        np.testing.assert_allclose(got[f"{pre}grad_norm{step}"],
                                   norms[step - 1], **TOL,
                                   err_msg=f"grad_norm {step}")
    mine = {k[len(pre) + 6:]: v for k, v in got.items()
            if k.startswith(pre + "param.")}
    assert sorted(mine) == sorted(params)
    if name.endswith("8bit"):
        return  # see the module's docstring
    for n, a in mine.items():
        np.testing.assert_allclose(a, params[n], **TOL, err_msg=n)


@pytest.mark.parametrize("name", ["adamw8bit", "lion8bit"])
def test_sharded_8bit_optimizer_matches_optax(ranks, name):
    """Three steps of the 8-bit optimizer over leaves sharded four ways
    against optax's on the whole leaves: codes and scales bit-identical,
    parameters within 1e-6."""
    _, got = ranks
    got = got[0]
    params, steps = w.opt8_inputs()

    def nest(flat):
        tree = {}
        for n, x in flat.items():
            a, b = n.split(".")
            tree.setdefault(a, {})[b] = jnp.asarray(x)
        return tree

    opt = joptim.make_optimizer(name, joptim.make_schedule("cosine", 1e-2,
                                                           10, 1))
    p = nest(params)
    state = opt.init(p)
    for g in steps:
        updates, state = opt.update(nest(g), state, p)
        p = optax.apply_updates(p, updates)
    for slot, by_name in _j_codes(state).items():
        assert sorted(by_name) == sorted(w.OPT8_SHAPES)
        for n, qs in by_name.items():
            np.testing.assert_array_equal(got[f"{name}.{slot}.q.{n}"],
                                          np.asarray(qs["q"]), err_msg=n)
            np.testing.assert_array_equal(got[f"{name}.{slot}.scale.{n}"],
                                          np.asarray(qs["scale"]), err_msg=n)
    for n, x in _flat(p).items():
        np.testing.assert_allclose(got[f"{name}.param.{n}"], np.asarray(x),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


@pytest.fixture(scope="module")
def side_one():
    """The side runs (LoRA, a Kosmos with CLIP frozen) in this process."""
    return w.side_runs()


@pytest.mark.parametrize("name,rank", [("lora", 0), ("kosmos", 2)])
def test_lora_and_frozen_kosmos_over_a_mesh(ranks, side_one, name, rank):
    """``LoraTrainer`` at data=2 (its factors' gradients all-reduced) and
    a Kosmos with CLIP frozen at fsdp=2 (its evaluation through the FSDP
    root too) against the same runs in one process, at 1e-4: losses,
    the evaluation's loss, factors and parameters."""
    _, got = ranks
    got = got[rank]
    want = side_one[name]
    mine = {k[len(f"side.{name}."):]: v for k, v in got.items()
            if k.startswith(f"side.{name}.")}
    assert sorted(mine) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(mine[k], v, **TOL, err_msg=k)


@pytest.mark.parametrize("kind,rank", [("data2", 1), ("fsdp2", 3)])
def test_mesh_ranks_agree(ranks, kind, rank):
    """Both ranks of a mesh log the same losses and hold the same whole
    parameters and optimizer state."""
    _, got = ranks
    lead = rank - 1
    keys = [k for k in got[lead] if k.startswith(kind + ".")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(got[rank][k], got[lead][k], err_msg=k)


@pytest.mark.parametrize("name", ["lion", "adamw"])
def test_two_rank_checkpoint_resumes_in_one(ranks, tmp_path, name):
    """The fsdp=2 run's step-1 checkpoint (written by rank 0 in the
    single-process format) resumes in one process: its step 2 gives the
    two ranks' parameters and loss; the step-2 checkpoint holds them."""
    out, got = ranks
    saved = out / f"ckpt_{name}"
    assert sorted(os.listdir(saved)) == ["step_1", "step_2"]
    resume = tmp_path / "resume"
    shutil.copytree(saved / "step_1", resume / "step_1")
    cfg = w.train_config()
    tc = w.train_cfg(name, resume=True, output_dir=str(resume))
    trainer = ttrainer.Trainer(
        lambda g: KosmosLanguage(cfg, generator=g, device="cpu"),
        ttrainer.lm_loss_fn(cfg), tc, device="cpu")
    logs = {}
    state, _ = trainer.run(w.train_batches(), log_fn=logs.__setitem__)
    assert sorted(logs) == [2]
    pre = f"fsdp2.{name}."
    np.testing.assert_allclose(logs[2]["loss"], got[2][pre + "loss2"],
                               rtol=1e-6)
    final = tckpt._load(str(saved / "step_2"), tckpt.STATE_FILE)["params"]
    for n, p in state["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), got[2][pre + "param." + n],
                                   rtol=1e-6, atol=1e-6, err_msg=n)
        np.testing.assert_array_equal(final[n].numpy(),
                                      got[2][pre + "param." + n])


@pytest.mark.parametrize("name", ["lion", "adamw8bit"])
def test_fsdp_resumes_from_a_checkpoint(ranks, name):
    """Two ranks at fsdp=2 resume from the single-process-format step-1
    checkpoint (each loads its shard of every leaf and of the optimizer
    state): step 2 gives the uninterrupted run's loss, parameters and
    8-bit codes bit for bit."""
    _, got = ranks
    got = got[2]
    pre, again = f"fsdp2.{name}.", f"fsdp2_resumed.{name}."
    assert sorted(k for k in got if k.startswith(again + "loss")) == \
        [again + "loss2"]
    keys = [k for k in got if k.startswith(pre) and not k.endswith("1")]
    assert any(k.startswith(pre + "mu.q.") for k in keys) == \
        name.endswith("8bit")
    for k in keys:
        np.testing.assert_array_equal(got[again + k[len(pre):]], got[k],
                                      err_msg=k)


def test_fsdp_resumes_a_jax_checkpoint(ranks, jax_runs):
    """Two ranks at fsdp=2 resume JAX's step-1 Lion checkpoint (orbax:
    optax's state mapped onto the port's, each rank keeping its shard of
    every leaf and moment): step 2's loss and every parameter after it at
    1e-4 of JAX's uninterrupted run."""
    _, got = ranks
    losses, _, params = jax_runs["lion"]
    for r in (2, 3):
        pre = "fsdp2_jax.lion."
        assert sorted(k for k in got[r] if k.startswith(pre + "loss")) == \
            [pre + "loss2"]
        np.testing.assert_allclose(got[r][pre + "loss2"], losses[1],
                                   rtol=1e-4, atol=1e-4)
        for n, v in params.items():
            np.testing.assert_allclose(got[r][pre + "param." + n], v,
                                       rtol=1e-4, atol=1e-4, err_msg=n)


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------


def _jax_specs(tree):
    specs = jsh.param_specs(tree)
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        flat[name] = tuple(spec)
    return flat


def _spec_trees():
    g = torch.Generator().manual_seed(0)
    kosmos = TKosmos(kosmos_cfg(tcfg), generator=g, device="cpu")
    moe = KosmosLanguage(dataclasses.replace(
        w.train_config(), moe_experts=4, multiway=False), generator=g,
        device="cpu")
    lora_base = KosmosLanguage(w.train_config(), generator=g, device="cpu")
    lora_tree = tlora.attach_lora(to_tree(lora_base), tlora.strip_lora(
        tlora.add_lora(g, lora_base, 4))[1])
    stacked = jax.eval_shape(lambda k: jdec.init_decoder(k, dataclasses.replace(
        _jax_cfg(w.train_config()), scan_layers=True)), jax.random.PRNGKey(0))
    return {"kosmos": (kosmos, to_numpy_params(kosmos)),
            "moe": (moe, to_numpy_params(moe)),
            "lora": (lora_tree, jax.tree_util.tree_map(
                lambda t: t.detach().numpy(), lora_tree)),
            "stacked": (stacked, stacked)}


@pytest.mark.parametrize("tree", ["kosmos", "moe", "lora", "stacked"])
def test_param_specs_match_jax(tree):
    port_tree, jax_tree = _spec_trees()[tree]
    got = tsh.param_specs(port_tree)
    want = _jax_specs(jax_tree)
    assert sorted(got) == sorted(want)
    for n, spec in want.items():
        assert got[n] == spec, (n, got[n], spec)
    assert any(v for v in got.values())


@pytest.mark.parametrize("ndim", [0, 1, 2, 3])
def test_batch_spec_matches_jax(ndim):
    assert tsh.batch_spec(ndim) == tuple(jsh.batch_spec(ndim))


def test_shard_batch_without_a_mesh_and_per_process():
    batch = {"input_ids": np.arange(8).reshape(4, 2), "n": np.int32(3)}
    assert tsh.shard_batch(batch, None) is batch
    assert tsh.batch_shards(None) == (0, 1)


def test_hybrid_mesh_puts_nodes_on_data(ranks):
    """``make_hybrid_mesh(dcn_data=2, fsdp=2)`` over four processes: the
    ``data`` axis spans the two nodes (torchrun's rank order), ``fsdp``
    stays within one."""
    _, got = ranks
    np.testing.assert_array_equal(got[0]["hybrid_mesh"],
                                  np.arange(4).reshape(2, 2, 1, 1))


def test_single_process_needs_no_rendezvous(monkeypatch):
    """One process in all: ``initialize_distributed`` joins nothing and
    ``make_mesh`` gives the one-device mesh (None); a mesh of more ranks
    than processes raises."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.initialize_distributed() is False
    assert tmesh.make_mesh() is None
    assert tmesh.make_hybrid_mesh(dcn_data=1) is None
    with pytest.raises(ValueError, match="processes"):
        tmesh.make_mesh(data=2)
    with pytest.raises(ValueError, match="processes"):
        ttrainer.Trainer(None, None, ttrainer.TrainConfig(fsdp=2),
                         device="cpu")


# ---------------------------------------------------------------------------
# the training CLI under torchrun's environment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [["--data", "2"], ["--fsdp", "2"]],
                         ids=["data2", "fsdp2"])
def test_train_cli_distributed(tmp_path, flags):
    """``--distributed`` in two processes with torchrun's variables (the JAX
    CLI's ``initialize_distributed()`` returns before any rendezvous; the
    port's reads the environment): exit 0 on both ranks, the same logged
    losses, and rank 0 alone writes the checkpoint, the final parameters
    and the metrics file."""
    out = tmp_path / "out"
    argv = [sys.executable, "-m", "kosmosx_torch.scripts.train",
            "--distributed", "--model", "language", "--synthetic",
            "--layers", "1", "--dim", "32", "--ffn-dim", "64", "--heads", "4",
            "--vocab-size", "97", "--seq-len", "16", "--batch-size", "2",
            "--steps", "2", "--log-every", "1", "--checkpoint-every", "2",
            "--device", "cpu", "--output-dir", str(out),
            "--metrics-jsonl", str(tmp_path / "m.jsonl"), *flags]
    outs = w.launch("", 2, str(tmp_path), argv=argv)
    finals = []
    for rank, (rc, stdout, stderr) in enumerate(outs):
        assert rc == 0, (rank, stderr[-3000:])
        finals.append([ln for ln in stdout.splitlines()
                       if ln.startswith("final:")])
    assert finals[0] and finals[0] == finals[1]
    assert sorted(os.listdir(out)) == ["final", "step_2"]
    records = [json.loads(ln) for ln in
               (tmp_path / "m.jsonl").read_text().splitlines() if ln]
    assert [r["step"] for r in records] == [1, 2]
    saved = tckpt._load(str(out / "step_2"), tckpt.STATE_FILE)
    assert saved["step"] == 2 and saved["opt_state"]["count"] == 2
