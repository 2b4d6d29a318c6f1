"""kosmosx_torch's tensor parallelism against kosmosx_tpu on the CPU: the
meshes, the forward and greedy generation of a decoder cut over
``tensor``, the 8-bit optimizers over cut leaves, ``Trainer`` and
``LoraTrainer`` over ``tensor`` (with FSDP beside it), a Kosmos with CLIP
frozen, DPO's loss and gradients, a checkpoint saved at ``tensor=2``
resumed in one process, and W8 weights and LoRA factors over ``tensor``:
a W8 decoder's forward and generation (list and stacked codes), QLoRA,
and ``ServeEngine(mesh=)`` on a W8 model and with two adapters.

The multi-rank cases run once per module in four gloo processes
(``torch_dist_worker.py``'s ``tensor`` task) while the JAX references
are computed here. JAX's numbers do not depend on its mesh
(tests/test_train.py:131, tests/test_generate.py:133), so the references
run on one device: the forward at 1e-4, generation's tokens equal, the
training steps' losses, gradient norms and parameters at 1e-4 against
JAX's train step over the same global batches (LoRA through JAX's
``LoraTrainer`` from the port's initial factors, the frozen Kosmos through
JAX's ``Trainer``), DPO's metrics and gradients at 1e-4 against JAX's
``dpo_loss_fn``, and the 8-bit codes and scales bit-identical to optax's on
fed gradients. The W8 and LoRA cases hold fp32 at 1e-4 and greedy tokens
equal against JAX's unsharded W8 (its own ``quantize_params_w8``) or LoRA
run.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kosmosx_tpu.core.config as jcfg
import torch_dist_worker as w
from kosmosx_torch.models.kosmos import Kosmos
from kosmosx_torch.models.language import KosmosLanguage
from kosmosx_torch.parallel import sharding as tsh
from kosmosx_torch.train import checkpoint as tckpt
from kosmosx_torch.train import lora as tlora
from kosmosx_torch.train import trainer as ttrainer
from kosmosx_torch.utils.jax_params import to_numpy_params
from kosmosx_tpu.generate.sampler import SamplingConfig as JSampling
from kosmosx_tpu.generate.sampler import generate_text as jgenerate
from kosmosx_tpu.nn import decoder as jdec
from kosmosx_tpu.parallel.mesh import make_mesh as jmake_mesh
from kosmosx_tpu.train import dpo as jdpo
from kosmosx_tpu.train import lora as jlora
from kosmosx_tpu.train import optim as joptim
from kosmosx_tpu.train import trainer as jtrainer
from kosmosx_tpu.utils import quantize as jquant
from test_torch_port_train_quant import _j_codes

TOL = dict(rtol=1e-4, atol=1e-4)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def jax_cfg(cfg_t):
    """A port config (``MagnetoConfig``, ``KosmosConfig`` and its parts)
    as JAX's, field by field."""
    if not dataclasses.is_dataclass(cfg_t):
        return cfg_t
    cls = getattr(jcfg, type(cfg_t).__name__)
    return cls(**{f.name: jax_cfg(getattr(cfg_t, f.name))
                  for f in dataclasses.fields(cls)})


def jax_train_cfg(tc):
    """A port ``TrainConfig`` as JAX's, on one device."""
    return jtrainer.TrainConfig(**{
        **{f.name: getattr(tc, f.name)
           for f in dataclasses.fields(jtrainer.TrainConfig)
           if hasattr(tc, f.name)},
        "data": 1, "fsdp": 1, "tensor": 1, "expert": 1})


def path_name(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def jax_lora_run(w8=False):
    """JAX's ``LoraTrainer`` (AdamW) over the LoRA side run's batches,
    from the base and the factors the port's ``LoraTrainer`` draws from
    the run's seed: (losses by step, factors by name). ``w8``: QLoRA over
    ``w.qlora_base()``, the W8 base the workers train on."""
    cfg, tc = w.train_config(), w.train_cfg("adamw")
    port = tlora.LoraTrainer(
        lambda g: KosmosLanguage(cfg, generator=g, device="cpu"), None, tc,
        w.LORA_RANK, device="cpu", base_params=w.qlora_base() if w8 else None)
    port.init_state()
    factors = {n: p.detach().numpy()
               for n, p in flat(port.state["lora"]).items()}
    jt = jlora.LoraTrainer(None, jtrainer.lm_loss_fn(jax_cfg(cfg)),
                           jax_train_cfg(tc), w.LORA_RANK,
                           mesh=jmake_mesh(devices=jax.devices()[:1]),
                           base_params=to_numpy_params(port.base_params))
    jt.init_state()
    leaves, tdef = jax.tree_util.tree_flatten_with_path(jt.state["lora"])
    names = [path_name(p) for p, _ in leaves]
    assert sorted(names) == sorted(factors)
    jt.state["lora"] = jax.tree_util.tree_unflatten(
        tdef, [jnp.asarray(factors[n]) for n in names])
    logs = {}
    with jax.default_matmul_precision("highest"):
        jt.run(iter(w.train_batches()), log_fn=logs.__setitem__)
    return ({s: float(m["loss"]) for s, m in logs.items()},
            {path_name(p): np.asarray(v) for p, v in
             jax.tree_util.tree_flatten_with_path(jt.state["lora"])[0]})


def jax_w8_refs():
    """JAX's unsharded W8 runs (its own ``quantize_params_w8`` of the
    port's seeded float weights, ``w.W8_MIN``): the tensor cases' forward
    and greedy generation, greedy tokens of the serving prompts on the W8
    serving decoder, and on the float one with each prompt's adapter
    (``w.SERVE_ADAPTERS``) attached, then QLoRA's run."""
    def weights(cfg_t):
        model = KosmosLanguage(cfg_t, generator=torch.Generator(
            ).manual_seed(w.TP_SEED), device="cpu")
        return jax.tree_util.tree_map(jnp.asarray, to_numpy_params(model))

    def greedy(params, cfg, prompt, new):
        return np.asarray(jgenerate(params, cfg, jnp.asarray(prompt),
                                    JSampling(max_new_tokens=new,
                                              greedy=True)))

    tokens, prompt = w.tp_tokens()
    cfg_t = w.tp_config()
    cfg, params = jax_cfg(cfg_t), jquant.quantize_params_w8(
        weights(cfg_t), min_size=w.W8_MIN)
    scfg_t = w.serve_config()
    scfg, sparams = jax_cfg(scfg_t), weights(scfg_t)
    adapters = {n: jax.tree_util.tree_map(jnp.asarray, t)
                for n, t in w.serve_adapters().items()}
    sw8 = jquant.quantize_params_w8(sparams, min_size=w.W8_MIN)
    with jax.default_matmul_precision("highest"):
        out = {"fwd": np.asarray(jdec.decoder_forward(
                   params, jnp.asarray(tokens), cfg)),
               "gen": greedy(params, cfg, prompt, w.GEN_NEW),
               "serve.w8": [greedy(sw8, scfg, [p], w.SERVE_NEW)[0]
                            for p in w.SERVE_PROMPTS],
               "serve.lora": [greedy(
                   sparams if a is None else
                   jlora.attach_lora(sparams, adapters[a]), scfg, [p],
                   w.SERVE_NEW)[0]
                   for p, a in zip(w.SERVE_PROMPTS, w.SERVE_ADAPTERS)]}
    out["qlora"] = jax_lora_run(w8=True)
    return out


def jax_kosmos_run():
    """JAX's ``Trainer`` on the frozen-CLIP Kosmos side run (AdamW under
    accumulation 2) from the port's seeded init, then its evaluation:
    (losses by step, eval loss, parameters by name)."""
    kcfg = w.kosmos_config()
    tc = w.train_cfg("adamw", freeze=("clip",), grad_accum=2,
                     warmup_steps=0)
    model = Kosmos(kcfg, generator=torch.Generator().manual_seed(
        w.TRAIN_SEED), device="cpu")
    jt = jtrainer.Trainer(None, jtrainer.kosmos_loss_fn(jax_cfg(kcfg)),
                          jax_train_cfg(tc),
                          mesh=jmake_mesh(devices=jax.devices()[:1]))
    jt.init_state(jax.tree_util.tree_map(jnp.asarray,
                                         to_numpy_params(model)))
    logs = {}
    with jax.default_matmul_precision("highest"):
        jt.run(iter(w.kosmos_batches()), log_fn=logs.__setitem__)
        ev = jt.evaluate(iter(w.kosmos_batches()[:1]))
    return ({s: float(m["loss"]) for s, m in logs.items()},
            float(ev["eval_loss"]),
            {k: np.asarray(v) for k, v in flat(jt.state["params"]).items()})


def jax_dpo():
    """JAX's ``dpo_loss_fn`` (beta 0.5), its metrics and gradients on
    ``w.dpo_run``'s policy, reference and preference batch."""
    cfg = jax_cfg(w.train_config())
    rng = np.random.default_rng(2)

    def rows(lo, hi):
        return [list(rng.integers(4, 97, int(rng.integers(lo, hi))))
                for _ in range(4)]

    batch = jdpo.preference_batch(rows(3, 8), rows(2, 10), rows(2, 10),
                                  length=20)
    policy, ref = (to_numpy_params(KosmosLanguage(
        w.train_config(), generator=torch.Generator().manual_seed(seed),
        device="cpu")) for seed in (0, 1))

    def loss_and_grad(p, r, b):
        b = jdpo.compute_ref_logprobs(r, cfg, b)
        return jax.value_and_grad(
            lambda pp: jdpo.dpo_loss_fn(cfg, beta=0.5)(pp, b, None),
            has_aux=True)(p)

    with jax.default_matmul_precision("highest"):
        (_, metrics), grads = jax.jit(loss_and_grad)(policy, ref, batch)
    return ({k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v) for k, v in flat(grads).items()})


def jax_train_run(cfg_t, params0, tc, batches, loss_fn=None):
    """JAX's train step on one device over ``batches``: (losses, grad
    norms, params by name, the last step's metrics)."""
    cfg = jax_cfg(cfg_t)
    sched = joptim.make_schedule(tc.schedule, tc.learning_rate,
                                 tc.total_steps, tc.warmup_steps)
    opt = joptim.make_optimizer(tc.optimizer, sched,
                                weight_decay=tc.weight_decay, beta1=tc.beta1,
                                beta2=tc.beta2, grad_clip=tc.grad_clip)
    step = jax.jit(jtrainer.make_train_step(
        loss_fn or jtrainer.lm_loss_fn(cfg), opt))
    state = {"params": params0, "opt_state": opt.init(params0),
             "step": jnp.zeros([], jnp.int32), "rng": jax.random.PRNGKey(0)}
    logs = []
    with jax.default_matmul_precision("highest"):
        for batch in batches:
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
            logs.append({k: float(v) for k, v in m.items()})
    params = {k: np.asarray(v) for k, v in flat(state["params"]).items()}
    return logs, params


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = tmp_path_factory.mktemp("tensor")
    return out, w.start("tensor", 4, str(out))


@pytest.fixture(scope="module")
def jax_refs(launched):
    """JAX's forward and greedy generation of the cut model's weights, its
    train steps (AdamW8bit, Lion) over the trainer cases' batches, its
    LoRA and frozen-Kosmos runs and its DPO loss and gradients."""
    cfg_t = w.tp_config()
    model = KosmosLanguage(cfg_t, generator=torch.Generator().manual_seed(
        w.TP_SEED), device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, to_numpy_params(model))
    cfg = jax_cfg(cfg_t)
    tokens, prompt = w.tp_tokens()
    with jax.default_matmul_precision("highest"):
        logits = np.asarray(jdec.decoder_forward(params, jnp.asarray(tokens),
                                                 cfg))
        gen = np.asarray(jgenerate(params, cfg, jnp.asarray(prompt),
                                   JSampling(max_new_tokens=w.GEN_NEW,
                                             greedy=True)))
    tcfg = w.train_config()
    tmodel = KosmosLanguage(tcfg, generator=torch.Generator().manual_seed(
        w.TRAIN_SEED), device="cpu")
    tparams = jax.tree_util.tree_map(jnp.asarray, to_numpy_params(tmodel))
    runs = {name: jax_train_run(tcfg, tparams, w.train_cfg(name),
                                w.train_batches())
            for name in ("adamw8bit", "lion")}
    return {"logits": logits, "gen": gen, "runs": runs,
            "lora": jax_lora_run(), "kosmos": jax_kosmos_run(),
            "dpo": jax_dpo(), "w8": jax_w8_refs()}


@pytest.fixture(scope="module")
def ranks(launched, jax_refs):
    out, procs = launched
    outs = w.finish(procs)
    for rank, (rc, stdout, stderr) in enumerate(outs):
        assert rc == 0 and f"RANK{rank} OK" in stdout, (rank, stderr[-3000:])
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("kind,shape", [("dt", (2, 1, 2, 1)),
                                        ("ft", (1, 2, 2, 1)),
                                        ("hybrid", (2, 1, 2, 1))])
def test_meshes_with_tensor(ranks, kind, shape):
    """``make_mesh(data=2, tensor=2)``, ``make_mesh(fsdp=2, tensor=2)`` and
    ``make_hybrid_mesh(dcn_data=2, tensor=2)``: JAX's (data, fsdp,
    tensor, expert) shapes over ranks in row-major order, the hybrid's
    ``data`` axis across the nodes (tests/test_train.py:205)."""
    _, got = ranks
    for r in range(4):
        np.testing.assert_array_equal(got[r][f"mesh.{kind}"],
                                      np.arange(4).reshape(shape))


@pytest.mark.parametrize("kind", ["dt", "ft"])
def test_forward_over_tensor_matches_jax(ranks, jax_refs, kind):
    """The forward of a decoder cut over tensor=2 (beside data=2, or FSDP
    over fsdp=2), each rank on its rows of the global batch, against JAX's
    forward on one device at 1e-4 (tests/test_train.py:131)."""
    _, got = ranks
    want = jax_refs["logits"]
    for r in range(4):
        shard = int(got[r][f"fwd.{kind}.shard"])
        rows = want[shard * 2:(shard + 1) * 2]
        np.testing.assert_allclose(got[r][f"fwd.{kind}"], rows, **TOL)


def test_layer_leaves_are_held_as_slices(ranks):
    """Over data=2 x tensor=2, every decoder-layer leaf whose spec names
    ``tensor`` holds its half on that dim and every other leaf is whole;
    under FSDP beside it a rank holds at most that half."""
    _, got = ranks
    model = KosmosLanguage(w.tp_config(), generator=torch.Generator(
        ).manual_seed(w.TP_SEED), device="cpu")
    specs = tsh.param_specs(model)
    cut = 0
    for n, p in model.named_parameters():
        want = list(p.shape)
        if n.startswith("layers.") and "tensor" in specs[n]:
            dim = specs[n].index("tensor")
            want[dim] //= 2
            cut += 1
        for r in range(4):
            np.testing.assert_array_equal(got[r][f"shape.dt.{n}"], want,
                                          err_msg=n)
            assert np.prod(got[r][f"shape.ft.{n}"]) <= np.prod(want), n
    assert cut == 2 * 2 * 12   # layers x multiway x (q, k, v, fc1: w and b;
    # out.w, fc2.w, ffn_ln scale and bias)


def test_generation_over_tensor_matches_jax(ranks, jax_refs):
    """Greedy generation over data=2 x tensor=2 (a cache of heads / 2 a
    rank) gives JAX's tokens (tests/test_generate.py:133)."""
    _, got = ranks
    for r in range(4):
        np.testing.assert_array_equal(got[r]["gen.dt"], jax_refs["gen"])


def test_remat_dots_over_tensor_matches_one_process(ranks):
    """Under remat "dots" (selective checkpointing saves the matmuls and
    recomputes the all-reduces after them) the gradients over data=2 x
    tensor=2 are one process's at 1e-5: the collectives leave the
    tensors they reduce untouched."""
    want = w.tp_remat_grads()
    for r in range(4):
        got = {k: v for k, v in ranks[1][r].items() if k.startswith("remat.")}
        assert sorted(got) == sorted(want)
        for n, g in want.items():
            np.testing.assert_allclose(got[n], g, rtol=1e-5, atol=1e-6,
                                       err_msg=n)


@pytest.mark.parametrize("name", ["adamw8bit", "lion8bit"])
def test_cut_8bit_optimizer_matches_optax(ranks, name):
    """Three steps of the 8-bit optimizer over leaves cut over tensor=2
    (a cut inside the 256-element blocks) with FSDP runs of each cut,
    against optax's on the whole leaves: codes and scales bit-identical,
    parameters within 1e-6."""
    _, got = ranks
    got = got[3]
    params, steps = w.opt8_cut_inputs()

    def nest(d):
        tree = {}
        for n, x in d.items():
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
    pre = f"opt8cut.{name}."
    for slot, by_name in _j_codes(state).items():
        assert sorted(by_name) == sorted(w.OPT8_CUT)
        for n, qs in by_name.items():
            np.testing.assert_array_equal(got[f"{pre}{slot}.q.{n}"],
                                          np.asarray(qs["q"]), err_msg=n)
            np.testing.assert_array_equal(got[f"{pre}{slot}.scale.{n}"],
                                          np.asarray(qs["scale"]), err_msg=n)
    for n, x in flat(p).items():
        np.testing.assert_allclose(got[f"{pre}param.{n}"], np.asarray(x),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("kind,name", [("dt", "adamw8bit"), ("ft", "lion")])
def test_trainer_over_tensor_matches_jax(ranks, jax_refs, kind, name):
    """Two steps of ``Trainer`` over data=2 x tensor=2 (AdamW8bit) and
    fsdp=2 x tensor=2 (Lion) on batches whose rows carry different
    padding, against JAX's step on one device over the same global
    batches: losses and gradient norms at 1e-4 on every rank, parameters
    at 1e-4 (AdamW8bit's left out, as tests/test_torch_port_parallel.py
    says why: a code one step off moves an update by a whole step)."""
    _, got = ranks
    logs, params = jax_refs["runs"][name]
    pre = f"{kind}.{name}."
    for r in range(4):
        for step in range(1, w.TRAIN_STEPS + 1):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[r][f"{pre}{key}{step}"],
                                           logs[step - 1][key], **TOL,
                                           err_msg=f"{key} {step}")
        mine = {k[len(pre) + 6:]: v for k, v in got[r].items()
                if k.startswith(pre + "param.")}
        assert sorted(mine) == sorted(params)
        if name.endswith("8bit"):
            assert any(k.startswith(pre + "mu.q.") for k in got[r])
            continue
        for n, a in mine.items():
            np.testing.assert_allclose(a, params[n], **TOL, err_msg=n)


@pytest.fixture(scope="module")
def side_one():
    return w.side_runs()


@pytest.mark.parametrize("name", ["lora", "kosmos"])
def test_lora_and_frozen_kosmos_over_tensor(ranks, side_one, name):
    """``LoraTrainer`` over data=2 x tensor=2 (whole factors, each rank
    applying its part of them) and a Kosmos with CLIP frozen over fsdp=2 x
    tensor=2 (AdamW under accumulation 2, its evaluation) against the
    same runs in one process, at 1e-4: a check beside
    ``test_lora_and_frozen_kosmos_over_tensor_matches_jax``."""
    _, got = ranks
    want = side_one[name]
    for r in range(4):
        mine = {k[len(f"side.{name}."):]: v for k, v in got[r].items()
                if k.startswith(f"side.{name}.")}
        assert sorted(mine) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(mine[k], v, **TOL, err_msg=k)


@pytest.mark.parametrize("name", ["lora", "kosmos"])
def test_lora_and_frozen_kosmos_over_tensor_matches_jax(ranks, jax_refs,
                                                        name):
    """``LoraTrainer`` over data=2 x tensor=2 against JAX's
    ``LoraTrainer`` from the same base and factors: losses and every
    factor at 1e-4 on every rank. A Kosmos with CLIP frozen over fsdp=2 x
    tensor=2 (AdamW under accumulation 2) against JAX's ``Trainer``:
    losses, the evaluation's loss and every parameter, CLIP's unchanged,
    at 1e-4 on every rank."""
    _, got = ranks
    pre = f"side.{name}."
    if name == "lora":
        losses, want = jax_refs["lora"]
        leaf = "lora."
    else:
        losses, eval_loss, want = jax_refs["kosmos"]
        leaf = "param."
    for r in range(4):
        mine = {k[len(pre + leaf):]: v for k, v in got[r].items()
                if k.startswith(pre + leaf)}
        assert sorted(mine) == sorted(want)
        for n, v in want.items():
            np.testing.assert_allclose(mine[n], v, **TOL, err_msg=n)
        assert sorted(losses) == [1, 2]
        for step, loss in losses.items():
            np.testing.assert_allclose(got[r][f"{pre}loss{step}"], loss,
                                       **TOL, err_msg=f"loss {step}")
        if name == "kosmos":
            np.testing.assert_allclose(got[r][pre + "eval_loss"], eval_loss,
                                       **TOL)


def test_dpo_over_tensor_matches_jax(ranks, jax_refs):
    """DPO over data=2 x tensor=2 (policy and reference cut, each rank on
    its rows): the five metrics and the policy's whole summed gradients
    against JAX's ``dpo_loss_fn`` on one device at 1e-4, on every rank."""
    metrics, grads = jax_refs["dpo"]
    for r in range(4):
        got = ranks[1][r]
        assert sorted(k[len("dpo."):] for k in got if k.startswith("dpo.")
                      and not k.startswith("dpo.grad.")
                      and k != "dpo.shard") == sorted(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(got[f"dpo.{k}"], v, **TOL, err_msg=k)
        mine = {k[len("dpo.grad."):]: v for k, v in got.items()
                if k.startswith("dpo.grad.")}
        assert mine and set(mine) <= set(grads)
        for n, g in grads.items():
            if n in mine:
                np.testing.assert_allclose(mine[n], g, **TOL, err_msg=n)
            else:  # a B expert no row reaches: JAX's gradient is zero
                assert not g.any(), n


def test_one_process_checkpoint_resumes_over_tensor(ranks):
    """The same step-1 checkpoint resumed at data=2 x tensor=2 (each rank
    loads its cut of every leaf and of the Lion state): step 2 gives the
    uninterrupted fsdp=2 x tensor=2 run's loss and parameters."""
    _, got = ranks
    for r in range(4):
        again = {k[len("dt_resumed.lion."):]: v for k, v in got[r].items()
                 if k.startswith("dt_resumed.lion.")}
        assert sorted(k for k in again if k.startswith("loss")) == ["loss2"]
        np.testing.assert_allclose(again["loss2"], got[r]["ft.lion.loss2"],
                                   rtol=1e-6)
        for k, v in again.items():
            if k.startswith("param."):
                np.testing.assert_allclose(v, got[r]["ft.lion." + k],
                                           rtol=1e-5, atol=1e-6, err_msg=k)


def test_dpo_over_tensor_matches_one_process(ranks):
    """DPO's loss, its metrics and the policy's gradients over data=2 x
    tensor=2 (policy and a deep-copied reference cut, each rank on its
    rows) are one process's at 1e-4: a check beside
    ``test_dpo_over_tensor_matches_jax``."""
    want = w.dpo_run()
    for r in range(4):
        for k, v in want.items():
            if k != "dpo.shard":
                np.testing.assert_allclose(ranks[1][r][k], v, **TOL,
                                           err_msg=k)


def test_tensor_checkpoint_resumes_in_one_process(ranks, tmp_path):
    """The fsdp=2 x tensor=2 Lion run's step-1 checkpoint (the whole
    state, written by rank 0) resumes in one process: its step 2 gives the
    four ranks' loss and parameters."""
    out, got = ranks
    saved = out / "ckpt_lion"
    assert sorted(os.listdir(saved)) == ["step_1", "step_2"]
    shutil.copytree(saved / "step_1", tmp_path / "step_1")
    cfg = w.train_config()
    trainer = ttrainer.Trainer(
        lambda g: KosmosLanguage(cfg, generator=g, device="cpu"),
        ttrainer.lm_loss_fn(cfg),
        w.train_cfg("lion", resume=True, output_dir=str(tmp_path)),
        device="cpu")
    logs = {}
    state, _ = trainer.run(w.train_batches(), log_fn=logs.__setitem__)
    assert sorted(logs) == [2]
    np.testing.assert_allclose(logs[2]["loss"], got[0]["ft.lion.loss2"],
                               rtol=1e-6)
    final = tckpt._load(str(saved / "step_2"), tckpt.STATE_FILE)["params"]
    for n, p in state["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   got[0]["ft.lion.param." + n],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        np.testing.assert_array_equal(final[n].numpy(),
                                      got[0]["ft.lion.param." + n])


@pytest.mark.parametrize("layout", ["list", "stack"])
def test_w8_over_tensor_matches_jax(ranks, jax_refs, layout):
    """A W8 decoder (the list layout, and the stacked one's shared (L, K,
    N) codes) cut over data=2 x tensor=2, the codes and scales by their
    float weights' rule: each rank's forward of its rows at 1e-4 against
    JAX's unsharded W8 forward, and greedy generation JAX's tokens
    (tests/test_generate.py:134-146)."""
    _, got = ranks
    want = jax_refs["w8"]
    for r in range(4):
        shard = int(got[r]["fwd.dt.shard"])
        np.testing.assert_allclose(got[r][f"w8.{layout}.fwd"],
                                   want["fwd"][shard * 2:(shard + 1) * 2],
                                   **TOL)
        np.testing.assert_array_equal(got[r][f"w8.{layout}.gen"],
                                      want["gen"])


def test_stacked_w8_codes_are_held_once_as_cuts(ranks):
    """Over tensor=2 the stacked layout's codes are held once on a rank,
    as their cut: (L, K, N/2) with (L, 1, N/2) scales for the
    column-parallel q and fc1, (L, K/2, N) with whole (L, 1, N) scales for
    the row-parallel out-projection and fc2; every layer's marker holds
    the same cut tensor."""
    _, got = ranks
    cfg = w.tp_config()
    n, d, f = cfg.layers, cfg.embed_dim, cfg.ffn_dim
    want = {"attn.q.A.w.q": (n, d, d // 2), "attn.q.A.w.scale": (n, 1, d // 2),
            "attn.out.A.w.q": (n, d // 2, d), "attn.out.A.w.scale": (n, 1, d),
            "ffn.A.fc1.w.q": (n, d, f // 2), "ffn.A.fc2.w.q": (n, f // 2, d),
            "ffn.A.fc2.w.scale": (n, 1, d)}
    assert sorted(want) == sorted(w.W8_STACK_LEAVES)
    for r in range(4):
        for leaf, shape in want.items():
            assert tuple(got[r][f"w8.stack.shape.{leaf}"]) == shape, leaf
            assert int(got[r][f"w8.stack.held.{leaf}"]) == 1, leaf


def test_qlora_over_tensor_matches_jax(ranks, jax_refs):
    """Two QLoRA ``LoraTrainer`` steps over data=2 x tensor=2 (the W8
    base's codes cut, the factors whole, each rank applying its part of
    them) against JAX's ``LoraTrainer`` on the same W8 base from the same
    factors: losses and every factor at 1e-4 on every rank."""
    _, got = ranks
    losses, want = jax_refs["w8"]["qlora"]
    for r in range(4):
        mine = {k[len("qlora.lora."):]: v for k, v in got[r].items()
                if k.startswith("qlora.lora.")}
        assert sorted(mine) == sorted(want)
        for n, v in want.items():
            np.testing.assert_allclose(mine[n], v, **TOL, err_msg=n)
        assert sorted(losses) == [1, 2]
        for step, loss in losses.items():
            np.testing.assert_allclose(got[r][f"qlora.loss{step}"], loss,
                                       **TOL, err_msg=f"loss {step}")


@pytest.mark.parametrize("case,devices", [("w8", [0, 1]), ("lora", [2, 3])])
def test_engine_w8_and_adapters_over_tensor_match_jax(ranks, jax_refs, case,
                                                      devices):
    """``ServeEngine(mesh=)`` at tensor=2 on a W8 model, and with two
    adapters on the two slots (the third request, on no adapter, takes a
    freed slot): every rank's greedy tokens equal JAX's unsharded W8 run,
    or JAX's run with each request's adapter attached; the adapters move
    the tokens off the base model's."""
    _, got = ranks
    want = jax_refs["w8"][f"serve.{case}"]
    for r in devices:
        for i, toks in enumerate(want):
            np.testing.assert_array_equal(got[r][f"serve.{case}.tokens{i}"],
                                          toks, err_msg=str(i))
    if case == "lora":   # the base model's tokens, one process
        base = w.serve_run(w.serve_config())
        assert all((want[i] != base[f"tokens{i}"]).any() for i in (0, 1))
        np.testing.assert_array_equal(want[2], base["tokens2"])
