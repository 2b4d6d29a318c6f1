"""kosmosx_torch weight-only int8 (W8) inference against the JAX package.

Quantization must give bit-identical codes and scales, in fp32 and bf16 and
in both layer layouts; the W8 matmuls, layers and the whole tiny Kosmos must
match JAX at fp32 with matmul precision "highest" (1e-4; the matmul kernels
at JAX's own tolerances, tests/test_w8_inference.py:135-151), with JAX's
Pallas kernels in interpret mode; greedy tokens must be identical. The port
runs the plain version of its kernels on the CPU. Inputs come from numpy
seeds; the tiny configs are those of tests/test_torch_port_model.py,
quantized with ``min_size=128`` so every projection, table and position
table is int8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.core.params import ParamTree
from kosmosx_torch.generate import sampler as tsamp
from kosmosx_torch.models.kosmos import Kosmos as TKosmos
from kosmosx_torch.models.language import KosmosLanguage as TLanguage
from kosmosx_torch.nn import layers as tlayers
from kosmosx_torch.ops import quant_matmul as tqm
from kosmosx_torch.train import checkpoint as tckpt
from kosmosx_torch.utils import quantize as tquant
from kosmosx_torch.utils.jax_params import from_jax_params, to_numpy_params
from kosmosx_tpu.core.dtypes import cast_tree
from kosmosx_tpu.generate import sampler as jsamp
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.nn import decoder as jdec
from kosmosx_tpu.nn import layers as jlayers
from kosmosx_tpu.ops import quant_matmul as jqm
from kosmosx_tpu.utils import quantize as jquant
from tests.test_torch_port_model import dec_cfg, kosmos_cfg

TOL = dict(atol=1e-4, rtol=1e-4)
MIN_SIZE = 128
LAYOUTS = {"list": False, "stacked": True}
J_KOSMOS_APPLY = jax.jit(JKosmos.apply, static_argnames=(
    "cfg", "use_padding_mask", "interpret"))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(x):
    return np.asarray(x, np.float32)


def _codes(rng, shape, std=0.3):
    """Quantized codes and scales of a random weight, by the JAX package."""
    qd = jquant._quantize_w(jnp.asarray(rng.standard_normal(shape) * std,
                                        jnp.float32))
    return np.array(qd["q"]), np.array(qd["scale"])


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def w8_kosmos(request):
    """A tiny Kosmos in one layer layout: JAX params, their W8 tree, and the
    port's model of the W8 tree."""
    scan = LAYOUTS[request.param]
    cfg_j = kosmos_cfg(jcfg, scan_layers=scan)
    cfg_t = kosmos_cfg(tcfg, scan_layers=scan)
    params = JKosmos.init(jax.random.PRNGKey(20), cfg_j)
    qparams = jquant.quantize_params_w8(params, min_size=MIN_SIZE)
    model = TKosmos(cfg_t, params=from_jax_params(_np_tree(qparams)))
    return cfg_j, cfg_t, params, qparams, model


# ---------------------------------------------------------------------------
# (a) quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_quantize_bit_identical_to_jax(layout, dtype):
    """The port's quantize_params_w8 of the bridged model equals, leaf by
    leaf and bit for bit, the bridge of JAX's quantized tree: same names,
    dtypes, codes and scales, and in the stacked layout the same shared
    (L, K, N) codes with per-layer markers."""
    scan = LAYOUTS[layout]
    cfg_j = kosmos_cfg(jcfg, scan_layers=scan)
    cfg_t = kosmos_cfg(tcfg, scan_layers=scan)
    params = JKosmos.init(jax.random.PRNGKey(21), cfg_j)
    if dtype == "bfloat16":
        params = cast_tree(params, jnp.bfloat16)
    want = TKosmos(cfg_t, params=from_jax_params(_np_tree(
        jquant.quantize_params_w8(params, min_size=MIN_SIZE))))
    got = tquant.quantize_params_w8(
        TKosmos(cfg_t, params=from_jax_params(_np_tree(params))),
        min_size=MIN_SIZE)
    assert isinstance(got, TKosmos) and got.config == cfg_t
    gp, wp = dict(got.named_parameters()), dict(want.named_parameters())
    assert sorted(gp) == sorted(wp)
    for name, w in wp.items():
        assert gp[name].dtype == w.dtype and torch.equal(gp[name], w), name
    assert gp["decoder.embed.table.q"].dtype == torch.int8
    assert gp["decoder.embed.table.scale"].dtype == torch.float32
    fc1 = [lp["ffn"]["A"]["fc1"]["w"] for lp in got["decoder"]["layers"]]
    if scan:
        assert fc1[0]["q"].shape == (2, 32, 64) and fc1[0]["q"] is fc1[1]["q"]
        assert [int(w["layer"]) for w in fc1] == [0, 1]
    else:
        assert fc1[0]["q"].shape == (32, 64) and "layer" not in fc1[0]
    assert tquant.w8_param_bytes(got) == tquant.w8_param_bytes(want)


def test_quantize_tree_and_bytes_match_jax():
    """On a plain dict tree: the per-row table rule, the min_size rule, a
    zero column's scale of 1, and the byte count of JAX's w8_param_bytes."""
    rng = np.random.default_rng(22)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    w[:, 3] = 0.0
    tree = {"lin": {"w": w, "b": rng.standard_normal(96).astype(np.float32)},
            "emb": {"table": rng.standard_normal((50, 32)).astype(np.float32)},
            "small": {"w": rng.standard_normal((8, 8)).astype(np.float32)}}
    jq = jquant.quantize_params_w8(jax.tree_util.tree_map(jnp.asarray, tree),
                                   min_size=100)
    tq = tquant.quantize_params_w8(
        jax.tree_util.tree_map(torch.from_numpy, tree), min_size=100)
    flat_j = jax.tree_util.tree_leaves_with_path(jq)
    flat_t = jax.tree_util.tree_leaves_with_path(tq)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=str(path))
    assert tq["lin"]["w"]["scale"][0, 3].item() == 1.0
    assert tquant.w8_param_bytes(tq) == jquant.w8_param_bytes(jq)


# ---------------------------------------------------------------------------
# (b) the W8 matmuls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(16, 256, 128), (5, 130, 70)])
def test_w8_matmul_matches_jax(m, k, n):
    rng = np.random.default_rng(m)
    q, scale = _codes(rng, (k, n))
    x = rng.standard_normal((m, k)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        kern = jqm.w8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                             interpret=True, block_m=64, block_k=128,
                             block_n=128)
        ref = jqm.w8_matmul_reference(jnp.asarray(x), jnp.asarray(q),
                                      jnp.asarray(scale))
    out = tqm.w8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                        torch.from_numpy(scale))
    for want in (kern, ref):
        np.testing.assert_allclose(out.numpy(), _np(want), rtol=1e-5, atol=1e-4)


def test_w8_matmul_leading_dims_bf16():
    rng = np.random.default_rng(23)
    q, scale = _codes(rng, (192, 257), std=1.0)
    x = rng.standard_normal((2, 3, 192)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    kern = jqm.w8_matmul(xj, jnp.asarray(q), jnp.asarray(scale), interpret=True)
    ref = jqm.w8_matmul_reference(xj.reshape(-1, 192), jnp.asarray(q),
                                  jnp.asarray(scale))
    out = tqm.w8_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(q),
                        torch.from_numpy(scale))
    assert out.shape == (2, 3, 257) and out.dtype == torch.bfloat16
    # the same expression as JAX's reference: equal but for bf16 rounding
    np.testing.assert_allclose(out.float().reshape(-1, 257).numpy(), _np(ref),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(out.float().numpy(), _np(kern), rtol=0.05,
                               atol=0.1)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_w8_matmul_stacked_matches_jax(layer):
    rng = np.random.default_rng(24)
    q, scale = _codes(rng, (3, 256, 384), std=0.2)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        kern = jqm.w8_matmul_stacked(
            jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
            jnp.int32(layer), interpret=True, block_m=16, block_k=128,
            block_n=128)
    tq, ts = torch.from_numpy(q), torch.from_numpy(scale)
    for li in (layer, torch.tensor(layer, dtype=torch.int32)):
        out = tqm.w8_matmul_stacked(torch.from_numpy(x), tq, ts, li)
        np.testing.assert_allclose(out.numpy(), _np(kern), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ["stacked_k", "stacked_n", "stacked_layer",
                                  "k_mismatch"])
def test_w8_matmul_shape_rules(case):
    """The JAX shape rules: stacked K and N multiples of 128 (:227), the
    contraction dims agree; a host layer index outside the stack raises."""
    x = torch.zeros(2, 256)
    q = torch.zeros(2, 256, 384, dtype=torch.int8)
    s = torch.ones(2, 1, 384)
    calls = {
        "stacked_k": lambda: tqm.w8_matmul_stacked(
            torch.zeros(2, 130), torch.zeros(2, 130, 384, dtype=torch.int8), s, 0),
        "stacked_n": lambda: tqm.w8_matmul_stacked(
            x, torch.zeros(2, 256, 70, dtype=torch.int8), torch.ones(2, 1, 70), 0),
        "stacked_layer": lambda: tqm.w8_matmul_stacked(x, q, s, 2),
        "k_mismatch": lambda: tqm.w8_matmul(x, q[0, :128], s[0]),
    }
    with pytest.raises(IndexError if case == "stacked_layer" else ValueError):
        calls[case]()


# ---------------------------------------------------------------------------
# (c) layers
# ---------------------------------------------------------------------------

def _layer_case(name, rng):
    """(JAX params, port params, JAX call, port call) of one W8 layer."""
    if name in ("linear", "linear_stacked"):
        stacked = name == "linear_stacked"
        w = rng.standard_normal((2, 48, 40) if stacked else (48, 40)) * 0.3
        p = {"w": jnp.asarray(w, jnp.float32),
             "b": jnp.asarray(rng.standard_normal(40), jnp.float32)}
        jq = jquant.quantize_params_w8(p, min_size=1)
        x = rng.standard_normal((3, 5, 48)).astype(np.float32)
        if stacked:  # the marker of layer 1, as JAX grafts it in its scan
            jq = {"w": dict(jq["w"], layer=jnp.int32(1)), "b": jq["b"][1]}
            tq = from_jax_params({"layers": _np_tree(
                {"w": {k: v for k, v in jq["w"].items() if k != "layer"},
                 "b": jnp.stack([jq["b"], jq["b"]])})})["layers"][1]
        else:
            tq = from_jax_params(_np_tree(jq))
        return (lambda: jlayers.linear(jq, jnp.asarray(x)),
                lambda: tlayers.linear(ParamTree(tq), torch.from_numpy(x)))
    table = {"table": jnp.asarray(rng.standard_normal((50, 32)) * 3.0,
                                  jnp.float32)}
    jq = jquant.quantize_params_w8(table, min_size=1)
    tq = ParamTree(from_jax_params(_np_tree(jq)))
    ids = rng.integers(0, 50, (2, 7)).astype(np.int32)
    if name == "embedding":
        return (lambda: jlayers.embedding(jq, jnp.asarray(ids)),
                lambda: tlayers.embedding(tq, torch.from_numpy(ids).long()))
    if name == "dense_weight":
        return (lambda: jlayers.dense_weight(jq["table"], jnp.float32),
                lambda: tlayers.dense_weight(tq["table"], torch.float32))
    return (lambda: jlayers.positional_embedding(jq, 9, offset=3),
            lambda: tlayers.positional_embedding(tq, 9, offset=3))


@pytest.mark.parametrize("name", ["linear", "linear_stacked", "embedding",
                                  "dense_weight", "positional_embedding"])
def test_w8_layers_match_jax(name):
    jcall, tcall = _layer_case(name, np.random.default_rng(25))
    with jax.default_matmul_precision("highest"):
        ref = jcall()
    out = tcall()
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("mode", ["auto", "off", "on"])
def test_w8_kernel_switch_on_cpu(mode):
    """"auto" and "off" take the plain version for CPU tensors; "on" asks
    for the kernel, which takes CUDA tensors only, and raises."""
    rng = np.random.default_rng(26)
    q, scale = _codes(rng, (48, 40))
    p = ParamTree({"w": {"q": torch.from_numpy(q),
                         "scale": torch.from_numpy(scale)}})
    x = torch.from_numpy(rng.standard_normal((5, 48)).astype(np.float32))
    before = tlayers._W8_KERNEL_MODE
    tlayers.set_w8_kernel(mode)
    try:
        if mode == "on":
            with pytest.raises(ValueError, match="CUDA"):
                tlayers.linear(p, x)
        else:
            out = tlayers.linear(p, x)
            np.testing.assert_allclose(
                out.numpy(), (x @ torch.from_numpy(q).float()
                              * torch.from_numpy(scale)).numpy(), **TOL)
    finally:
        tlayers.set_w8_kernel(before)
    with pytest.raises(ValueError):
        tlayers.set_w8_kernel("fast")


# ---------------------------------------------------------------------------
# (d) the slice: Kosmos.apply and generate_multimodal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text_len", [10, 250], ids=["plain", "flash"])
def test_w8_kosmos_apply_matches_jax(w8_kosmos, text_len):
    cfg_j, _, _, qparams, model = w8_kosmos
    rng = np.random.default_rng(27)
    toks = rng.integers(4, 97, (2, text_len)).astype(np.int32)
    images = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = J_KOSMOS_APPLY(qparams, jnp.asarray(toks), jnp.asarray(images),
                             cfg_j, interpret=True)
    out = model.apply(torch.from_numpy(toks).long(), torch.from_numpy(images))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_w8_generate_multimodal_matches_jax(w8_kosmos):
    cfg_j, cfg_t, _, qparams, model = w8_kosmos
    rng = np.random.default_rng(28)
    lengths = np.array([12, 7, 10], np.int32)
    toks = rng.integers(4, 97, (3, 12)).astype(np.int32)
    for r, n in enumerate(lengths):
        toks[r, n:] = 1
    images = rng.standard_normal((3, 3, 28, 28)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jsamp.generate_multimodal(
            qparams, cfg_j, jnp.asarray(toks), jnp.asarray(images),
            jsamp.SamplingConfig(max_new_tokens=6, greedy=True),
            prompt_lengths=jnp.asarray(lengths), interpret=True)
    out = tsamp.generate_multimodal(
        model, cfg_t, torch.from_numpy(toks).long(), torch.from_numpy(images),
        tsamp.SamplingConfig(max_new_tokens=6, greedy=True),
        prompt_lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_w8_quantized_port_model_matches_jax_w8(w8_kosmos):
    """The port quantizing its own bridged fp32 model computes what JAX's
    W8 model computes."""
    cfg_j, cfg_t, params, qparams, _ = w8_kosmos
    model = tquant.quantize_params_w8(
        TKosmos(cfg_t, params=from_jax_params(_np_tree(params))),
        min_size=MIN_SIZE)
    rng = np.random.default_rng(29)
    toks = rng.integers(4, 97, (2, 9)).astype(np.int32)
    images = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = J_KOSMOS_APPLY(qparams, jnp.asarray(toks), jnp.asarray(images),
                             cfg_j, interpret=True)
    out = model.apply(torch.from_numpy(toks).long(), torch.from_numpy(images))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_w8_generate_text_matches_jax():
    cfg_j = dec_cfg(jcfg, scan_layers=True)
    params = jquant.quantize_params_w8(
        jdec.init_decoder(jax.random.PRNGKey(30), cfg_j), min_size=MIN_SIZE)
    model = TLanguage(dec_cfg(tcfg, scan_layers=True),
                      params=from_jax_params(_np_tree(params)))
    lengths = np.array([9, 4], np.int32)
    toks = np.random.default_rng(30).integers(4, 97, (2, 9)).astype(np.int32)
    toks[1, 4:] = 1
    with jax.default_matmul_precision("highest"):
        ref = jsamp.generate_text(
            params, cfg_j, jnp.asarray(toks),
            jsamp.SamplingConfig(max_new_tokens=6, greedy=True),
            prompt_lengths=jnp.asarray(lengths), interpret=True)
    out = tsamp.generate_text(
        model, model.config, torch.from_numpy(toks).long(),
        tsamp.SamplingConfig(max_new_tokens=6, greedy=True),
        prompt_lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# (e) checkpoints and the parameter tree
# ---------------------------------------------------------------------------

def test_w8_checkpoint_roundtrip(w8_kosmos, tmp_path):
    """W8 parameters survive save_params / restore_params bit-exactly, into
    a model of another seed; stacked codes stay shared after the restore
    (the counterpart of tests/test_w8_inference.py:94-106)."""
    _, cfg_t, _, _, model = w8_kosmos
    target = tquant.quantize_params_w8(
        TKosmos(cfg_t, generator=torch.Generator().manual_seed(1),
                device="cpu"),
        min_size=MIN_SIZE)
    path = tckpt.save_params(model, str(tmp_path / "w8"))
    tckpt.restore_params(path, target)
    want = dict(model.named_parameters())
    got = dict(target.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    lay = target["decoder"]["layers"]
    shared = lay[0]["attn"]["q"]["A"]["w"]["q"] is lay[1]["attn"]["q"]["A"]["w"]["q"]
    assert shared == cfg_t.decoder.scan_layers


def test_w8_tree_names_and_numpy(w8_kosmos):
    """named_parameters yields the JAX paths, each stacked tensor once;
    to_numpy_params returns the codes as int8; training W8 weights raises."""
    _, cfg_t, _, qparams, model = w8_kosmos
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(set(names))
    assert "decoder.layers.0.attn.q.A.w.q" in names
    assert ("decoder.layers.1.attn.q.A.w.q" in names) != cfg_t.decoder.scan_layers
    back = to_numpy_params(model)
    layer0 = back["decoder"]["layers"][0]["ffn"]["A"]["fc1"]["w"]
    jq = qparams["decoder"]["layers"]
    jw = jq["ffn"]["A"]["fc1"]["w"] if cfg_t.decoder.scan_layers else \
        jq[0]["ffn"]["A"]["fc1"]["w"]
    assert layer0["q"].dtype == np.int8
    np.testing.assert_array_equal(layer0["q"], np.asarray(jw["q"]))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        model.set_trainable()
