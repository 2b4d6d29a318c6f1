"""kosmosx_torch's 8-bit optimizers against kosmosx_tpu/train/quant.py on
the CPU.

Blockwise moment codes and scales are held bit-identical to JAX's (int8
and uint8, sizes that are not a multiple of 256, all-zero blocks);
AdamW8bit and Lion8bit through ``make_optimizer`` (global clip, masked
decay) are fed the same gradients as JAX's chain for 5 steps: codes and
scales identical, parameters within 1e-6, in fp32 and with bf16
parameters. Bit-identical codes need gradients below the clip: once the
clip scales them, they divide by the global norm, which optax sums in
XLA's order and the port in torch's, an ulp apart at times; the clipped
case holds the parameters within 1e-6 and every code within one step of
JAX's (scales within 5e-7 relative, two ulps: the second moment
squares the gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kosmosx_torch.train import optim as toptim
from kosmosx_torch.train import quant as tquant
from kosmosx_tpu.train import optim as joptim
from kosmosx_tpu.train import quant as jquant

OPT_TOL = dict(atol=1e-6, rtol=1e-6)


def _moment(rng, size, signed, zero_blocks=()):
    x = rng.standard_normal(size).astype(np.float32) * 1e-3
    if not signed:
        x = x * x
    for b in zero_blocks:
        x[b * 256:(b + 1) * 256] = 0.0
    return x


@pytest.mark.parametrize("signed", [True, False], ids=["int8", "uint8"])
@pytest.mark.parametrize("size,zero_blocks", [(1, ()), (255, ()), (256, (0,)),
                                              (1000, (1,)), (4097, (0, 3)),
                                              (65536, (7,))])
def test_quantize_blockwise_matches_jax(signed, size, zero_blocks):
    rng = np.random.default_rng(size)
    x = _moment(rng, size, signed, zero_blocks)
    j = jquant.quantize_blockwise(jnp.asarray(x), signed=signed)
    t = tquant.quantize_blockwise(torch.from_numpy(x), signed=signed)
    assert t["q"].dtype == (torch.int8 if signed else torch.uint8)
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    np.testing.assert_array_equal(t["scale"].numpy(), np.asarray(j["scale"]))
    for b in zero_blocks:
        if b < t["scale"].shape[0]:
            assert t["scale"][b, 0] == 1.0 and not t["q"][b].any()
    shape = (size,) if size % 5 else (5, size // 5)
    back_j = jquant.dequantize_blockwise(j, shape)
    back_t = tquant.dequantize_blockwise(t, shape)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))


def _tree(rng, dtype):
    """A decayed matmul weight of 300 x 7 (not a multiple of 256), its B
    twin that never gets a gradient, a LayerNorm scale and a table."""
    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    tree = {"embed": {"table": arr(6, 50)},
            "layers": [{"attn": {"q": {"A": {"w": arr(300, 7)},
                                       "B": {"w": arr(300, 7)}},
                                 "inner_ln": {"A": {"scale": np.ones(7, np.float32)}}}}]}
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), tree)


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


def _j_codes(state):
    """name -> {"q", "scale"} of a chained 8-bit state's ``mu`` / ``nu``."""
    inner = state[1]
    is_q = lambda t: isinstance(t, dict) and set(t) == {"q", "scale"}
    out = {}
    for slot in ("mu", "nu"):
        tree = getattr(inner, slot)
        if tree is None:
            continue
        leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_q)[0]
        out[slot] = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path): v for path, v in leaves}
    return out


@pytest.mark.parametrize("dtype,clipped", [("float32", False),
                                           ("float32", True),
                                           ("bfloat16", False)],
                         ids=["fp32", "fp32_clipped", "bf16"])
@pytest.mark.parametrize("name", ["adamw8bit", "lion8bit"])
def test_8bit_optimizer_matches_optax(name, dtype, clipped):
    """5 steps of ``make_optimizer`` (clip 1.0) on both sides, the
    gradients' norm about 0.25-0.75, or 147 and 25 at the clipped case's
    steps 1-2; the B expert gets no gradient (decay alone moves it).

    In the clipped (fp32) case the port's global norm and optax's differ
    by up to one ulp (the same squares summed in another order: asserted
    at each step), and the clipped moments by up to one
    code step and 5e-7 of a scale; unclipped, they are identical."""
    rng = np.random.default_rng(3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tree = _tree(rng, np.float32)
    flat = _flat(tree)
    scales = (3.0, 0.5, 0.01, 0.005, 0.015) if clipped else \
        (0.015, 0.01, 0.005, 0.012, 0.008)
    grads = [{n: rng.standard_normal(a.shape).astype(np.float32) * s
              for n, a in flat.items() if ".B." not in n} for s in scales]
    sched = ("constant", 0.01, 10, 2)
    opt_j = joptim.make_optimizer(name, joptim.make_schedule(*sched),
                                  weight_decay=0.1)
    params_j = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree)
    state_j = opt_j.init(params_j)
    params_t = {n: torch.from_numpy(a.copy()).to(tdt) for n, a in flat.items()}
    opt_t = toptim.make_optimizer(name, toptim.make_schedule(*sched),
                                  params_t, weight_decay=0.1)
    for step, g in enumerate(grads):
        g_tree = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(g.get(
                ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path), np.zeros_like(a)), jdt), tree)
        norm_j = np.float32(optax.global_norm(g_tree))
        assert (norm_j > 1.0) == (clipped and step < 2)
        if clipped:
            norm_t = toptim.global_norm(
                {n: (torch.from_numpy(g[n]) if n in g else None)
                 for n in opt_t.order}).numpy()
            assert abs(norm_t - norm_j) <= np.spacing(norm_j), (norm_t, norm_j)
        updates, state_j = opt_j.update(g_tree, state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        opt_t.step({n: (torch.from_numpy(g[n]).to(tdt) if n in g else None)
                    for n in flat})
        codes_j = _j_codes(state_j)
        state_t = opt_t.state_dict()
        assert sorted(codes_j) == sorted(s for s in ("mu", "nu")
                                         if state_t[s])
        for slot, leaves in codes_j.items():
            for n, qs in leaves.items():
                q_t, s_t = state_t[slot][n]["q"], state_t[slot][n]["scale"]
                msg = f"{slot} {n} after step {step}"
                if clipped:
                    dq = np.abs(q_t.numpy().astype(np.int32)
                                - np.asarray(qs["q"]).astype(np.int32))
                    assert dq.max() <= 1, msg
                    np.testing.assert_allclose(s_t.numpy(),
                                               np.asarray(qs["scale"]),
                                               rtol=5e-7, atol=0, err_msg=msg)
                else:
                    np.testing.assert_array_equal(q_t.numpy(),
                                                  np.asarray(qs["q"]), msg)
                    np.testing.assert_array_equal(s_t.numpy(),
                                                  np.asarray(qs["scale"]), msg)
        for n, a in _flat(params_j).items():
            np.testing.assert_allclose(
                params_t[n].float().numpy(), np.asarray(a, np.float32),
                **OPT_TOL, err_msg=f"{n} after step {step}")
    b = "layers.0.attn.q.B.w"
    assert not np.array_equal(params_t[b].float().numpy(), flat[b])  # decayed
    assert opt_t.state_dict()["count"] == 5


def test_8bit_moments_hold_about_one_byte_a_value():
    """The moments never stay in fp32: codes of 1 byte and a 4-byte scale
    per 256 values, per moment."""
    p = {"w": torch.zeros(1000, 300), "b": torch.zeros(300)}
    sched = toptim.make_schedule("constant", 1e-3, 10, 1)
    for name, moments in (("adamw8bit", 2), ("lion8bit", 1)):
        opt = toptim.make_optimizer(name, sched, p)
        blocks = -(-300_000 // 256) + -(-300 // 256)
        assert opt.moment_bytes() == moments * blocks * (256 + 4)
        assert all(t.dtype in (torch.int8, torch.uint8, torch.float32)
                   for slot in (opt.mu, opt.nu) for m in slot.values()
                   for t in m.values())
