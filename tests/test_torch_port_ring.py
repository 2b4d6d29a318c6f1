"""kosmosx_torch.parallel's context parallelism against kosmosx_tpu on the
CPU: the ring and zigzag ring flash attention and the sequence-parallel
step.

The multi-rank cases run once per module in four gloo processes
(``torch_dist_worker.py``'s ``ring`` task: every ring case, then every SP
step, on the kernels' plain versions), and are held here against the
plain JAX functions, as JAX's own (slow, interpret-mode) ring tests hold
theirs: the ring's output and gradients against ``mha_reference`` and its
``jax.grad`` at JAX's B, H, D = 2, 4, 64 and shards of 128, at JAX's bar
of 2e-4; the SP step's loss and SGD-updated parameters against JAX's
single-device ``decoder_forward`` (plain attention) under
``optax.sgd(0.1)``, at JAX's bars (loss 1e-5, parameters 5e-4). The pure
functions (``_merge``, the zigzag layout, ``shift_labels``) are checked in
this process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kosmosx_tpu.core.config as jcfg
import torch_dist_worker as w
from kosmosx_torch.models.language import KosmosLanguage
from kosmosx_torch.parallel import ring_attention as tra
from kosmosx_torch.parallel import seq_parallel as tsp
from kosmosx_torch.utils.jax_params import to_numpy_params
from kosmosx_tpu.nn import decoder as jdec
from kosmosx_tpu.ops.flash_attention import mha_reference
from kosmosx_tpu.parallel import ring_attention as jra
from kosmosx_tpu.parallel import seq_parallel as jsp

RING_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The ``ring`` task's four ranks, started before the JAX references
    are computed so that both run at once."""
    out = tmp_path_factory.mktemp("ring")
    return out, w.start("ring", 4, str(out))


@pytest.fixture(scope="module")
def ranks(launched, sp_reference):
    """The ``ring`` task's results, one dict a rank."""
    out, procs = launched
    outs = w.finish(procs)
    for rank, (rc, stdout, stderr) in enumerate(outs):
        assert rc == 0 and f"RANK{rank} OK" in stdout, (rank, stderr[-3000:])
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


# ---------------------------------------------------------------------------
# ring and zigzag attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(w.RING_CASES))
def test_ring_matches_mha_reference(ranks, name):
    schedule, s, causal, segs = w.RING_CASES[name]
    q, k, v, g, seg = (jnp.asarray(x) for x in w.ring_inputs(s, len(name)))
    kw = dict(causal=causal, sm_scale=w.D ** -0.5)
    if segs:
        kw.update(q_segment_ids=seg, kv_segment_ids=seg)

    def loss(q, k, v):
        return jnp.sum(mha_reference(q, k, v, **kw) * g)

    with jax.default_matmul_precision("highest"):
        o = mha_reference(q, k, v, **kw)
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    got = ranks[0]
    for key, want in zip(("o", "dq", "dk", "dv"), (o, *grads)):
        np.testing.assert_allclose(got[f"{name}.{key}"], np.asarray(want),
                                   **RING_TOL, err_msg=f"{name} {key}")


def test_merge_matches_jax():
    """The log2-domain combine on (B, H, L) statistics against JAX's on
    (B, H, L, 1), with rows where both ``m`` are -inf, one partial has seen
    no key (``l`` 0), or the max comes from either side."""
    rng = np.random.default_rng(0)
    o1, o2 = (rng.standard_normal((2, 3, 6, 4)).astype(np.float32)
              for _ in range(2))
    l1, l2 = (rng.uniform(0.5, 3, (2, 3, 6)).astype(np.float32)
              for _ in range(2))
    m1, m2 = (rng.standard_normal((2, 3, 6)).astype(np.float32) * 4
              for _ in range(2))
    m1[0, 0, 0] = m2[0, 0, 0] = -np.inf
    l1[0, 0, 0] = l2[0, 0, 0] = 0.0
    m1[1, 2, 3], l1[1, 2, 3] = -np.inf, 0.0
    l2[0, 1, 5] = 0.0
    got = tra._merge(*(torch.from_numpy(x) for x in (o1, l1, m1, o2, l2, m2)))
    want = jra._merge(*(jnp.asarray(x) for x in
                        (o1, l1[..., None], m1[..., None], o2, l2[..., None],
                         m2[..., None])))
    for a, b in zip(got, (want[0], want[1][..., 0], want[2][..., 0])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert not any(torch.isnan(t).any() for t in got)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_zigzag_layout_matches_jax(s):
    x = np.arange(3 * 8 * s * 5).reshape(3, 8 * s, 5).astype(np.int32)
    assert tra.zigzag_chunk_order(s) == jra.zigzag_chunk_order(s)
    perm = tra.zigzag_permute(torch.from_numpy(x), s)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(
        jra.zigzag_permute(jnp.asarray(x), s)))
    np.testing.assert_array_equal(tra.zigzag_unpermute(perm, s).numpy(), x)
    for i in range(s):
        np.testing.assert_array_equal(
            tra.zigzag_position_offsets(i, 8, s).numpy(),
            np.asarray(jra.zigzag_position_offsets(i, 8, s)))


def test_shift_labels_matches_jax():
    tokens = np.random.default_rng(1).integers(2, 50, (3, 11)).astype(np.int32)
    got = tsp.shift_labels(torch.from_numpy(tokens), 1)
    want = jsp.shift_labels(jnp.asarray(tokens), 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ring_input_checks():
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="both segment-id"):
        tra.ring_flash_attention(q, q, q, None,
                                 q_segment_ids=torch.zeros(1, 8))
    with pytest.raises(ValueError, match="one even"):
        tra.zigzag_ring_flash_attention(q[:, :, :7], q[:, :, :7],
                                        q[:, :, :7], None)


# ---------------------------------------------------------------------------
# the sequence-parallel step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sp_reference(launched):
    """JAX's single-device step per case: (loss, updated params by name)."""
    cfg_t = w.sp_config()
    model = KosmosLanguage(cfg_t, generator=torch.Generator().manual_seed(
        w.SP_SEED), device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, to_numpy_params(model))
    cfg = jcfg.MagnetoConfig(**{f.name: getattr(cfg_t, f.name) for f in
                                dataclasses.fields(jcfg.MagnetoConfig)
                                if hasattr(cfg_t, f.name)})
    cfg = dataclasses.replace(cfg, use_flash_attention=False,
                              scan_layers=False)
    opt = optax.sgd(w.SP_LR)
    out = {}
    for padded in (False, True):
        tokens, seg = (jnp.asarray(x) for x in w.sp_batch(padded))
        labels, weights = jsp.shift_labels(tokens, cfg.padding_idx)
        weights = weights * (seg >= 0)

        def loss_fn(p):
            logits = jdec.decoder_forward(p, tokens, cfg, segment_ids=seg
                                          ).astype(jnp.float32)
            logz = jax.scipy.special.logsumexp(logits, axis=-1)
            true = jnp.take_along_axis(logits, labels[..., None], -1)[..., 0]
            return jnp.sum((logz - true) * weights) / jnp.maximum(
                jnp.sum(weights), 1.0)

        with jax.default_matmul_precision("highest"):
            loss, grads = jax.value_and_grad(loss_fn)(params)
        new = optax.apply_updates(params, opt.update(grads, opt.init(params),
                                                     params)[0])
        flat = {}

        def walk(tree, prefix):
            if isinstance(tree, dict):
                for k_, v_ in tree.items():
                    walk(v_, f"{prefix}.{k_}" if prefix else k_)
            elif isinstance(tree, (list, tuple)):
                for i_, v_ in enumerate(tree):
                    walk(v_, f"{prefix}.{i_}")
            else:
                flat[prefix] = np.asarray(tree)

        walk(new, "")
        out[padded] = (float(loss), flat)
    return out


@pytest.mark.parametrize("name", list(w.SP_CASES))
def test_seq_parallel_step_matches_single_device(ranks, sp_reference, name):
    """Loss and SGD-updated parameters of the data 2 x sequence 2 step
    against JAX's single-device step, on every rank, and the ranks equal
    to each other bit for bit."""
    _, padded, _ = w.SP_CASES[name]
    loss, params = sp_reference[padded]
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(float(got[f"{name}.loss"]), loss,
                                   rtol=1e-5, atol=1e-5, err_msg=str(rank))
        names = [k for k in got if k.startswith(f"{name}.param.")]
        assert sorted(n.split(".param.", 1)[1] for n in names) == \
            sorted(params)
        for key in names:
            n = key.split(".param.", 1)[1]
            np.testing.assert_allclose(got[key], params[n], rtol=5e-4,
                                       atol=5e-4, err_msg=f"{rank} {n}")
            np.testing.assert_array_equal(got[key], ranks[0][key])


def test_seq_parallel_step_checks_its_axis():
    cfg = w.sp_config(sequence_axis="seq")
    with pytest.raises(ValueError, match="must match"):
        tsp.make_seq_parallel_train_step(cfg, None, None)
    with pytest.raises(ValueError, match="sequence_schedule"):
        w.sp_config(sequence_schedule="spiral").check_supported()


def test_sequence_axis_needs_its_group():
    cfg = w.sp_config(sequence_axis="sequence")
    model = KosmosLanguage(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(ValueError, match="sequence_group"):
        model.apply(torch.zeros(1, 8, dtype=torch.long))
