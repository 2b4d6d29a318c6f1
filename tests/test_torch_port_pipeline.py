"""kosmosx_torch's pipeline schedules (``parallel/pipeline.py``, GPipe and
1F1B) against kosmosx_tpu on the CPU.

The oracle is JAX's single-device step (tests/test_pipeline.py:42-78):
the pipelined step must give the loss and the SGD update of a plain
full-batch forward and CE. The schedules run once per module in four gloo
processes (``torch_dist_worker.py``'s ``pipeline`` task) at pipe=2 x
data=2 with M = S, and at pipe=4 with M = 8 (stash reuse) and M = 2,
while the reference is computed here; the loss at rtol 1e-5 and the
parameters at 5e-5, JAX's tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from kosmosx_torch.models.language import KosmosLanguage
from kosmosx_torch.parallel import pipeline as tpp
from kosmosx_torch.train.optim import make_optimizer, make_schedule
from kosmosx_torch.utils.jax_params import to_numpy_params
from kosmosx_tpu.nn import decoder as jdec
from test_torch_port_tensor import flat, jax_cfg

KINDS = ("gpipe", "1f1b")


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    return out, w.start("pipeline", 4, str(out))


@pytest.fixture(scope="module")
def reference(launched):
    """JAX's loss and SGD-updated parameters on one device (the layer
    list: the same math as the stacked layout)."""
    model = KosmosLanguage(w.pp_config(), generator=torch.Generator(
        ).manual_seed(w.PP_SEED), device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, to_numpy_params(model))
    cfg = jax_cfg(dataclasses.replace(w.pp_config(), scan_layers=False))
    tokens, labels, weights = (jnp.asarray(x) for x in w.pp_batch())

    def loss_fn(p):
        logits = jdec.decoder_forward(p, tokens, cfg).astype(jnp.float32)
        logz = jax.scipy.special.logsumexp(logits, axis=-1)
        true = jnp.take_along_axis(logits, labels[..., None], -1)[..., 0]
        return jnp.sum((logz - true) * weights) / jnp.maximum(
            jnp.sum(weights), 1.0)

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.value_and_grad(loss_fn)(params)
    new = jax.tree_util.tree_map(lambda p, g: p - w.PP_LR * g, params, grads)
    return float(loss), {k: np.asarray(v) for k, v in flat(new).items()}


@pytest.fixture(scope="module")
def ranks(launched, reference):
    out, procs = launched
    outs = w.finish(procs)
    for rank, (rc, stdout, stderr) in enumerate(outs):
        assert rc == 0 and f"RANK{rank} OK" in stdout, (rank, stderr[-3000:])
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(w.PP_CASES))
def test_pipeline_step_matches_single_device(ranks, reference, case, kind):
    """One pipelined SGD step against JAX's single-device step: every
    rank's loss at rtol 1e-5; each stage holds its layers alone (the
    replicated leaves on every rank), and every leaf, whichever rank holds
    it, at 5e-5 (tests/test_pipeline.py:55-78,140-165)."""
    data, pipe, m = w.PP_CASES[case]
    loss, params = reference
    pre = f"{case}.{kind}."
    held = {}
    for r in range(4):
        got = ranks[r]
        np.testing.assert_allclose(got[pre + "loss"], loss, rtol=1e-5)
        names = {k[len(pre) + 6:] for k in got if k.startswith(pre + "param.")}
        stage = r % pipe
        per = w.pp_config().layers // pipe
        mine = {int(n.split(".")[1]) for n in names if n.startswith("layers.")}
        assert mine == set(range(stage * per, (stage + 1) * per))
        for n in names:
            held.setdefault(n, got[pre + "param." + n])
            np.testing.assert_allclose(got[pre + "param." + n], params[n],
                                       rtol=5e-5, atol=5e-5, err_msg=n)
    assert sorted(held) == sorted(params)
    want_ticks = m + pipe - 1 if kind == "gpipe" else m + 2 * pipe - 2
    assert int(ranks[0][pre + "ticks"]) == want_ticks
    if kind == "1f1b":
        assert int(ranks[0][pre + "slots"]) == min(2 * pipe - 1, m)


def test_pipeline_state_specs_shape():
    """Layer leaves and their moments are sharded over ``pipe``, the rest
    replicated (tests/test_pipeline.py:108-114)."""
    model = KosmosLanguage(w.pp_config(), generator=torch.Generator(
        ).manual_seed(0), device="cpu")
    named = dict(model.named_parameters())
    opt = make_optimizer("lion", make_schedule("constant", 1e-3, 10), named)
    specs = tpp.pipeline_state_specs({"params": model, "opt_state": opt})
    assert specs["params"]["layers.0.ffn.A.fc1.w"] == ("pipe",)
    assert specs["params"]["embed.table"] == ()
    assert specs["opt_state"]["mu"]["layers.3.attn.q.A.w"] == ("pipe",)
    assert specs["opt_state"]["mu"]["ln.A.scale"] == ()


class _Mesh:
    """The two dims a schedule's checks read."""

    def __getitem__(self, name):
        return type("Dim", (), {"size": lambda self: 4})()


@pytest.mark.parametrize("make", [tpp.make_pipeline_train_step,
                                  tpp.make_pipeline_train_step_1f1b],
                         ids=KINDS)
@pytest.mark.parametrize("change,match", [
    (dict(scan_layers=False), "scan_layers"), (dict(layers=6), "divisible"),
    (dict(dropout=0.1), "dropout")], ids=["scan_layers", "layers", "dropout"])
def test_pipeline_validates_config(make, change, match):
    """What JAX refuses, with its words (tests/test_pipeline.py:117-128)."""
    with pytest.raises(ValueError, match=match):
        make(dataclasses.replace(w.pp_config(), **change), None, _Mesh())
