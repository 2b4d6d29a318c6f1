"""kosmosx_torch's MoE decoder over a mesh against kosmosx_tpu on the CPU:
the routing loss over a data mesh (each rank's share of the global
batch's loss), the ``expert`` axis (the expert stacks held ``E / ep`` a
rank, beside ``data`` and beside ``tensor``), ``ServeEngine(mesh=)`` over
``tensor`` and the training CLI's ``--tensor`` and ``--expert``.

The multi-rank cases run once per module in four gloo processes
(``torch_dist_worker.py``'s ``expert`` task), the CLI in two pairs of
processes, all while the JAX references are computed here, on one device
(JAX's numbers do not depend on its mesh): the MoE train steps at 1e-4
(loss, ``moe_aux``, gradient norm, parameters), greedy generation's
tokens equal.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from kosmosx_torch.parallel import sharding as tsh
from kosmosx_torch.utils.jax_params import to_numpy_params
from kosmosx_tpu.generate.sampler import SamplingConfig as JSampling
from kosmosx_tpu.generate.sampler import generate_text as jgenerate
from test_torch_port_tensor import jax_cfg, jax_train_run

TOL = dict(rtol=1e-4, atol=1e-4)
MOE_RUNS = {"data2.adamw": ([0, 1], "adamw"), "data2.lion": ([2, 3], "lion"),
            "de.adamw": ([0, 1, 2, 3], "adamw"),
            "et.lion": ([0, 1, 2, 3], "lion")}
CLI = {"tensor": ["--tensor", "2"],
       "expert": ["--expert", "2", "--moe-experts", "4", "--no-multiway"]}


def _cli_argv(out, flags):
    return [sys.executable, "-m", "kosmosx_torch.scripts.train",
            "--distributed", "--model", "language", "--synthetic",
            "--layers", "1", "--dim", "32", "--ffn-dim", "64", "--heads", "4",
            "--vocab-size", "97", "--seq-len", "16", "--batch-size", "2",
            "--steps", "2", "--log-every", "1", "--checkpoint-every", "0",
            "--device", "cpu", "--output-dir", str(out), "--no-final-save",
            *flags]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = tmp_path_factory.mktemp("expert")
    clis = {name: w.start("", 2, str(out), argv=_cli_argv(out / name, flags))
            for name, flags in CLI.items()}
    return out, w.start("expert", 4, str(out)), clis


@pytest.fixture(scope="module")
def jax_refs(launched):
    """JAX's MoE train steps (AdamW, Lion) on one device from the skewed
    routers, and its greedy tokens for the serving prompts."""
    model = w.moe_model(torch.Generator().manual_seed(w.TRAIN_SEED))
    params = jax.tree_util.tree_map(jnp.asarray, to_numpy_params(model))
    runs = {name: jax_train_run(w.moe_config(), params, w.train_cfg(name),
                                w.train_batches())
            for name in ("adamw", "lion")}
    gen = {}
    for case, kw in w.SERVE_CASES.items():
        cfg_t = w.serve_config(**kw)
        from kosmosx_torch.models.language import KosmosLanguage

        tm = KosmosLanguage(cfg_t, generator=torch.Generator().manual_seed(
            w.TP_SEED), device="cpu")
        sp = jax.tree_util.tree_map(jnp.asarray, to_numpy_params(tm))
        # the decode kernel's Pallas version runs on a TPU only: JAX's
        # plain attention over the same cache
        jc = jax_cfg(dataclasses.replace(cfg_t, decode_attn_kernel=False))
        with jax.default_matmul_precision("highest"):
            gen[case] = [np.asarray(jgenerate(
                sp, jc, jnp.asarray([p]),
                JSampling(max_new_tokens=w.SERVE_NEW, greedy=True)))[0]
                for p in w.SERVE_PROMPTS]
    return {"runs": runs, "gen": gen}


@pytest.fixture(scope="module")
def ranks(launched, jax_refs):
    out, procs, _ = launched
    outs = w.finish(procs)
    for rank, (rc, stdout, stderr) in enumerate(outs):
        assert rc == 0 and f"RANK{rank} OK" in stdout, (rank, stderr[-3000:])
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("run", list(MOE_RUNS))
def test_moe_trainer_over_a_mesh_matches_jax(ranks, jax_refs, run):
    """Two MoE ``Trainer`` steps from routers skewed x4, on batches whose
    rows carry different padding: at data=2 (each rank's routing loss its
    share of the global batch's, so the ranks' shares sum to JAX's
    global-batch loss in value and gradient), at data=2 x expert=2 and at
    expert=2 x tensor=2, against JAX's step on one device: loss,
    ``moe_aux`` and gradient norm of each step and the parameters at 1e-4
    on every rank of the mesh."""
    devices, name = MOE_RUNS[run]
    logs, params = jax_refs["runs"][name]
    pre = f"moe.{run}."
    for r in devices:
        got = ranks[r]
        for step in range(1, w.TRAIN_STEPS + 1):
            for key in ("loss", "moe_aux", "grad_norm"):
                np.testing.assert_allclose(got[f"{pre}{key}{step}"],
                                           logs[step - 1][key], **TOL,
                                           err_msg=f"{key} {step}")
        mine = {k[len(pre) + 6:]: v for k, v in got.items()
                if k.startswith(pre + "param.")}
        assert sorted(mine) == sorted(params)
        for n, a in mine.items():
            np.testing.assert_allclose(a, params[n], **TOL, err_msg=n)


@pytest.mark.parametrize("run", ["de.adamw", "et.lion"])
def test_expert_stacks_are_held_by_expert(ranks, run):
    """Over expert=2 every expert stack holds E / 2 = 2 experts a rank
    (with tensor=2 beside it, fc1, fc1's bias and the sub-LN also half
    their columns and fc2 half its rows); the router and the rest of the
    layer are whole."""
    model = w.moe_model(torch.Generator().manual_seed(w.TRAIN_SEED))
    specs = tsh.param_specs(model)
    tp = 2 if run.startswith("et") else 1
    experts = 0
    for n, p in model.named_parameters():
        want = list(p.shape)
        spec = specs[n]
        if n.startswith("layers."):
            for dim, ax in enumerate(spec):
                if ax == "expert":
                    want[dim] //= 2
                    experts += 1
                elif ax == "tensor":
                    want[dim] //= tp
        for r in range(4):
            np.testing.assert_array_equal(
                ranks[r][f"moe.{run}.shape.{n}"], want, err_msg=n)
    assert experts == 2 * 6  # layers x (fc1 w, b; fc2 w, b; ffn_ln scale, bias)


@pytest.mark.parametrize("case,devices", [("t2.fp32", [0, 1]),
                                          ("t2.int8", [2, 3]),
                                          ("ft.fp32", [0, 1, 2, 3])])
def test_engine_over_tensor_matches_jax(ranks, jax_refs, case, devices):
    """``ServeEngine(mesh=)`` at tensor=2 (fp32, and an int8 cache through
    the decode kernel's plain version) and at fsdp=2 x tensor=2 (the fsdp
    ranks replicas): every rank's greedy tokens equal JAX's and the pool
    holds heads / 2 = 2 heads a rank (tests/test_serve.py:626)."""
    want = jax_refs["gen"][case.split(".")[1]]
    cfg = w.serve_config()
    for r in devices:
        got = ranks[r]
        for i, toks in enumerate(want):
            np.testing.assert_array_equal(
                got[f"serve.{case}.tokens{i}"], toks, err_msg=str(i))
        assert list(got[f"serve.{case}.pool_k"]) == [
            2, cfg.heads // 2, 48, cfg.head_dim]


def test_engine_over_tensor_matches_one_process(ranks):
    """The one-process engine gives the tensor-parallel engines' tokens
    and holds every head."""
    for case in ("fp32", "int8"):
        one = w.serve_run(w.serve_config(**w.SERVE_CASES[case]))
        assert list(one["pool_k"])[1] == w.serve_config().heads
        for i in range(len(w.SERVE_PROMPTS)):
            np.testing.assert_array_equal(
                ranks[0 if case == "fp32" else 2][f"serve.t2.{case}.tokens{i}"],
                one[f"tokens{i}"])


@pytest.mark.parametrize("name", list(CLI))
def test_train_cli_distributed_tensor_and_expert(launched, name):
    """``--distributed --tensor 2`` and ``--distributed --expert 2`` (an
    MoE decoder) in two processes with torchrun's variables: exit 0 on
    both ranks and the same final metrics on both (the ranks of one batch
    shard compute one loss)."""
    outs = w.finish(launched[2][name])
    finals = []
    for rank, (rc, stdout, stderr) in enumerate(outs):
        assert rc == 0, (rank, stderr[-3000:])
        finals.append([ln for ln in stdout.splitlines()
                       if ln.startswith("final:")])
    assert finals[0] and finals[0] == finals[1]
    assert ("moe_aux" in finals[0][0]) == (name == "expert")
