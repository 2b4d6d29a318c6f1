"""kosmosx_torch.train.lora and the LoRA branch of nn/layers.linear against
the JAX package, on the CPU (fp32, bar 1e-4 as
tests/test_torch_parity.py:48; JAX at matmul precision "highest").

LoRA factors carry across with ``from_jax_params``, stacked layers sliced
per layer. ``add_lora`` draws ``a`` from a torch.Generator, so its values
cannot match JAX's: its structure, shapes, zero ``b`` and scale do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.models.language import KosmosLanguage as TLanguage
from kosmosx_torch.nn import decoder as tdec
from kosmosx_torch.nn import layers as tlayers
from kosmosx_torch.train import lora as tlora
from kosmosx_torch.utils.jax_params import from_jax_params
from kosmosx_torch.utils.quantize import quantize_params_w8
from kosmosx_tpu.nn import decoder as jdec
from kosmosx_tpu.nn import layers as jlayers
from kosmosx_tpu.train import lora as jlora
from kosmosx_tpu.utils.quantize import quantize_params_w8 as jquantize
from tests.test_torch_port_model import dec_cfg

TOL = dict(atol=1e-4, rtol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(x):
    return np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict/list tree of tensors or
    arrays."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree.float() if isinstance(
            tree, torch.Tensor) and tree.is_floating_point() else tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _randomized(key, tree, scale=0.1):
    def randomize(path, x):
        last = [p.key for p in path if hasattr(p, "key")][-1]
        if last in ("a", "b"):
            k = jax.random.fold_in(key, len(jax.tree_util.keystr(path)))
            return jax.random.normal(k, x.shape, x.dtype) * scale
        return x

    return jax.tree_util.tree_map_with_path(randomize, tree)


@pytest.fixture(scope="module", params=[True, False], ids=["stacked", "list"])
def adapted(request):
    """A JAX decoder (stacked or list layers, multiway) with random
    rank-3 factors in every default target, and the same in the port."""
    cfg_kw = dict(scan_layers=request.param)
    jc = dec_cfg(jcfg, **cfg_kw)
    jp = jdec.init_decoder(jax.random.PRNGKey(0), jc)
    key = jax.random.PRNGKey(3)
    base, lora = jlora.strip_lora(jlora.add_lora(key, jp, rank=3))
    lora = _randomized(key, lora)
    jadapted = jlora.attach_lora(base, lora)
    return jc, dec_cfg(tcfg, **cfg_kw), jadapted, from_jax_params(
        _np_tree(jadapted), "cpu")


def test_from_jax_params_carries_lora(adapted):
    """The adapted decoder's logits through the port (the factors carried
    by ``from_jax_params``) against JAX's."""
    jc, tc, jtree, ttree = adapted
    tokens = np.random.default_rng(0).integers(4, 97, (2, 9)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = jdec.decoder_forward(jtree, jnp.asarray(tokens), jc)
    got = tdec.decoder_forward(TLanguage(tc, params=ttree),
                               torch.as_tensor(tokens).long(), tc)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    lora_leaves = [k for k in _flat(ttree) if ".lora." in k]
    assert lora_leaves and len(lora_leaves) == 3 * 2 * 6 * 2  # a,b,scale


def test_strip_attach_merge_match_jax(adapted):
    """strip_lora, attach_lora and merge_lora give JAX's trees, leaf for
    leaf (merged weights at 1e-6)."""
    _, tc, jtree, ttree = adapted
    jbase, jl = jlora.strip_lora(jtree)
    tbase, tl = tlora.strip_lora(ttree)
    for got, want in ((tbase, jbase), (tl, jl)):
        want = _flat(from_jax_params(_np_tree(want), "cpu"))
        got = _flat(got)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    again = _flat(tlora.attach_lora(tbase, tl))
    for k, v in _flat(ttree).items():
        np.testing.assert_array_equal(again[k], v)
    with jax.default_matmul_precision("highest"):
        jm = _flat(from_jax_params(_np_tree(jlora.merge_lora(jtree)), "cpu"))
    tm = _flat(tlora.merge_lora(ttree))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=1e-6, rtol=1e-6)
    assert tlora.num_lora_params(tl) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jl))


def test_add_lora_structure(adapted):
    """add_lora on the port tree: the paths and shapes of JAX's factors,
    b zero, scale alpha / rank, and the adapted model the base model."""
    jc, tc, jtree, _ = adapted
    jbase = jlora.strip_lora(jtree)[0]
    model = TLanguage(tc, params=from_jax_params(_np_tree(jbase), "cpu"))
    g = torch.Generator().manual_seed(0)
    t = tlora.strip_lora(tlora.add_lora(g, model, 4, alpha=8.0))[1]
    j = from_jax_params(_np_tree(jlora.strip_lora(
        jlora.add_lora(jax.random.PRNGKey(0), jbase, 4, alpha=8.0))[1]), "cpu")
    tf, jf = _flat(t), _flat(j)
    assert sorted(tf) == sorted(jf)
    for k in jf:
        assert tf[k].shape == jf[k].shape, k
        if k.endswith(".b"):
            assert not tf[k].any()
        if k.endswith(".scale"):
            np.testing.assert_array_equal(tf[k], jf[k])
    tokens = torch.randint(4, 97, (1, 7), generator=g)
    np.testing.assert_array_equal(
        tdec.decoder_forward(tlora.attach_lora(model, t), tokens, tc).numpy(),
        tdec.decoder_forward(model, tokens, tc).numpy())
    with pytest.raises(ValueError, match="rank"):
        tlora.add_lora(g, model, 0)


def test_per_row_linear_matches_jax():
    """Per-row factors (B, in, r), (B, r, out), (B,) on a (B, L, in) input,
    after the dense product and before the bias, against JAX's linear."""
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"w": f(16, 12), "b": f(12),
              "lora": {"a": f(3, 16, 2), "b": f(3, 2, 12),
                       "scale": np.array([0.5, 1.0, 2.0], np.float32)}}
    x = f(3, 5, 16)
    with jax.default_matmul_precision("highest"):
        want = jlayers.linear(jax.tree_util.tree_map(jnp.asarray, params),
                              jnp.asarray(x))
    got = tlayers.linear(from_jax_params(params, "cpu"), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("stacked", [False, True])
def test_w8_lora_linear_matches_jax(stacked):
    """W8 base weights + LoRA (QLoRA), 2-D codes and a stacked marker,
    against JAX's linear on the same codes."""
    rng = np.random.default_rng(2)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = f(3, 16, 12) if stacked else f(16, 12)
    with jax.default_matmul_precision("highest"):
        jw = jquantize({"w": jnp.asarray(w)}, min_size=1)["w"]
    lora = {"a": f(16, 2), "b": f(2, 12), "scale": np.float32(0.7)}
    x = f(2, 4, 16)
    jp = {"w": dict(jw, layer=1) if stacked else jw, "b": f(12), "lora": lora}
    with jax.default_matmul_precision("highest"):
        want = jlayers.linear(jax.tree_util.tree_map(jnp.asarray, jp),
                              jnp.asarray(x))
    tp = from_jax_params(_np_tree({k: v for k, v in jp.items() if k != "w"}),
                         "cpu")
    tw = from_jax_params(_np_tree(jw), "cpu")
    tp["w"] = dict(tw, layer=torch.tensor(1)) if stacked else tw
    got = tlayers.linear(tp, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_w8_model_keeps_lora_unmerged():
    """A W8 model takes adapter factors (the delta added at run time) and
    refuses to merge them."""
    cfg = dataclasses.replace(dec_cfg(tcfg), scan_layers=True)
    model = quantize_params_w8(TLanguage(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
        min_size=1)
    g = torch.Generator().manual_seed(1)
    adapted = tlora.add_lora(g, model, 2)
    tokens = torch.randint(4, 97, (1, 6), generator=g)
    np.testing.assert_array_equal(
        tdec.decoder_forward(adapted, tokens, cfg).numpy(),
        tdec.decoder_forward(model, tokens, cfg).numpy())
    with pytest.raises(ValueError, match="W8"):
        tlora.merge_lora(adapted)


def test_lora_state_dict_round_trip(adapted, tmp_path):
    """A lora tree saved as ``{path: tensor}`` with ``save_params`` loads
    back into the same tree (list positions kept)."""
    from kosmosx_torch.train.checkpoint import restore_params, save_params

    _, _, _, ttree = adapted
    lora = tlora.strip_lora(ttree)[1]
    save_params(tlora.lora_state_dict(lora), str(tmp_path))
    back = tlora.lora_from_state_dict(restore_params(str(tmp_path)))
    assert _flat(back).keys() == _flat(lora).keys()
    for k, v in _flat(lora).items():
        np.testing.assert_array_equal(_flat(back)[k], v)
