"""kosmosx_torch's shared-trunk encoder (nn/unified.py) and the tree shapes
of the modality zoo against the JAX package.

Each of the four tokenizers and the trunk at the JAX tests' small
``UnifiedConfig`` (hidden 32, 2 layers, 4 heads, 128 tokens, audio frames
of 64 samples); the errors for zero tokens and for more than
``max_tokens``; a 512-token sequence with ``use_flash_attention`` on, which
routes the trunk's attention through the flash wrapper (its plain version
on the CPU); ``KosmosAny(unified=True)`` end to end. Then the parameter
trees: lists of lists and ``None`` subtrees (r3d18, the lean video tower,
wav2vec2's optional leaves) and the existing ``Kosmos`` and MoE decoder
trees round-trip through ``from_jax_params``, ``ParamTree`` and
``to_numpy_params`` unchanged. JAX trees are the port's seeded inits
carried across (layouts checked against ``jax.eval_shape`` of JAX's
inits). Bar: 1e-4 in fp32 (tests/test_torch_parity.py:48).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.core.params import ParamTree
from kosmosx_torch.models.any_modality import KosmosAny as TAny
from kosmosx_torch.models.kosmos import Kosmos as TKosmos
from kosmosx_torch.nn import unified as tu
from kosmosx_torch.nn import vision as tvision
from kosmosx_torch.utils.jax_params import from_jax_params, to_numpy_params
from kosmosx_tpu.models.any_modality import KosmosAny as JAny
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.nn import decoder as jdec
from kosmosx_tpu.nn import unified as ju
from kosmosx_tpu.nn import video as jvideo
from kosmosx_tpu.nn import wav2vec2 as jw2v
from test_hf_audio_video import _W2V

TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(hidden_dim=32, layers=2, heads=4, mlp_dim=64, max_tokens=128,
             image_patch=14, audio_patch=64, video_tube_t=2, video_tube_hw=16)
JCFG, TCFG = ju.UnifiedConfig(**SMALL), tu.UnifiedConfig(**SMALL)
J_TOKENIZE = jax.jit(ju._tokenize, static_argnames=("modality", "cfg"))
J_ENCODE = jax.jit(ju.unified_encode, static_argnames=("modality", "cfg"))


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


INPUTS = {"image": _normal(1, (2, 3, 28, 28)), "audio": _normal(2, (2, 650)),
          "video": _normal(3, (2, 3, 4, 32, 32)), "any": _normal(4, (2, 5, 7))}
TOKENS = {"image": 4, "audio": 10, "video": 8, "any": 1}


def shapes(tree):
    return jax.tree_util.tree_map(np.shape, tree)


def jax_shapes(fn):
    return jax.tree_util.tree_map(
        lambda s: s.shape, jax.eval_shape(fn, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def trunk():
    """The port's seeded trunk, and its tree as JAX runs it."""
    tp = ParamTree(tu.init_unified_encoder(torch.Generator().manual_seed(0),
                                           TCFG, "cpu"))
    tree = to_numpy_params(tp)
    assert shapes(tree) == jax_shapes(
        lambda k: ju.init_unified_encoder(k, JCFG))
    return tp, tree


@pytest.mark.parametrize("modality", list(INPUTS))
def test_tokenizer_matches_jax(trunk, modality):
    tp, tree = trunk
    x = INPUTS[modality]
    ref = np.asarray(J_TOKENIZE(tree, jnp.asarray(x), modality=modality,
                                cfg=JCFG))
    out = tu._tokenize(tp, torch.from_numpy(x), modality, TCFG)
    assert out.shape == ref.shape == (2, TOKENS[modality], 32)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("modality", list(INPUTS))
def test_trunk_matches_jax(trunk, modality):
    tp, tree = trunk
    x = INPUTS[modality]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(J_ENCODE(tree, jnp.asarray(x), modality=modality,
                                  cfg=JCFG))
    out = tu.unified_encode(tp, torch.from_numpy(x), modality, TCFG)
    assert out.shape == ref.shape == (2, 1, 32)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_modality_embedding_separates_audio_and_any(trunk):
    tp, _ = trunk
    x = torch.ones(2, 640)
    assert not torch.allclose(tu.unified_encode(tp, x, "audio", TCFG),
                              tu.unified_encode(tp, x, "any", TCFG))


@pytest.mark.parametrize("modality,shape,match", [
    ("audio", (2, 63), "shorter than one patch"),
    ("video", (2, 3, 1, 32, 32), "smaller than one tube"),
    ("video", (2, 3, 4, 8, 32), "smaller than one tube"),
    ("audio", (2, 64 * 128), "exceed max_tokens"),
    ("smell", (2, 64), "unknown modality"),
])
def test_errors(trunk, modality, shape, match):
    tp, tree = trunk
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match=match):
        tu.unified_encode(tp, torch.from_numpy(x), modality, TCFG)
    with pytest.raises(ValueError, match=match):
        ju.unified_encode(tree, jnp.asarray(x), modality, JCFG)


def test_512_tokens_take_the_flash_wrapper(monkeypatch):
    """511 audio frames and the CLS token: l = 512, so with
    ``use_flash_attention`` every trunk layer calls the non-causal flash
    wrapper without xPos (its plain version for CPU tensors), and the
    result is JAX's plain trunk's."""
    kw = dict(SMALL, max_tokens=512)
    tcfg_f = tu.UnifiedConfig(**kw, use_flash_attention=True)
    jcfg_p = ju.UnifiedConfig(**kw)
    tp = ParamTree(tu.init_unified_encoder(torch.Generator().manual_seed(1),
                                           tcfg_f, "cpu"))
    calls = []
    flash = tvision.flash_attention

    def spy(q, k, v, **kwargs):
        calls.append((tuple(q.shape), kwargs))
        return flash(q, k, v, **kwargs)

    monkeypatch.setattr(tvision, "flash_attention", spy)
    x = _normal(5, (1, 511 * 64 + 17))
    out = tu.unified_encode(tp, torch.from_numpy(x), "audio", tcfg_f)
    assert calls == [((1, 4, 512, 8), dict(causal=False, sm_scale=1.0))] * 2
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(J_ENCODE(to_numpy_params(tp), jnp.asarray(x),
                                  modality="audio", cfg=jcfg_p))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_kosmos_any_unified_mode():
    """One shared trunk, not per-modality towers; logits as JAX's model's on
    the carried tree."""
    dec = dict(vocab_size=64, embed_dim=32, ffn_dim=64, layers=2, heads=4,
               max_positions=64, use_flash_attention=False, multiway=False,
               dropout=0.0, attention_dropout=0.0)
    jm = JAny(decoder=jcfg.MagnetoConfig(**dec), unified=True,
              unified_config=JCFG)
    media = [("audio", INPUTS["audio"]), ("video", INPUTS["video"]),
             ("any", INPUTS["any"])]
    jprep = jm.prepare_media(media)
    tm = TAny(tcfg.MagnetoConfig(**dec), unified=True, unified_config=TCFG,
              params=from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                            jm.params), "cpu"))
    tprep = tm.prepare_media(media)
    assert "unified_enc" in tm and "audio_enc" not in tm
    assert sorted(tm._modules) == sorted(jm.params)
    toks = np.ones((2, 8), np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda p, t, xs: jm.apply(
            p, t, media=[(m, x) for (m, _), x in zip(jprep, xs)]))(
            jm.params, jnp.asarray(toks), [x for _, x in jprep]))
    with torch.no_grad():
        out = tm.apply(torch.from_numpy(toks), media=tprep)
    assert out.shape == ref.shape == (2, 8 + 3, 64)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


# ---------------------------------------------------------------------------
# tree round trips
# ---------------------------------------------------------------------------


def random_tree(fn, seed=0):
    """JAX's init layout (``jax.eval_shape``, None leaves kept) filled with
    seeded numpy values."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        jax.eval_shape(fn, jax.random.PRNGKey(0)))


def assert_round_trip(tree, module):
    back = to_numpy_params(module)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


ZOO_TREES = {
    "r3d18": lambda k: jvideo.init_video_encoder(
        k, jcfg.VideoConfig(arch="r3d18")),
    "lean_skip_none": lambda k: jvideo.init_video_encoder(
        k, jcfg.VideoConfig(hidden_dim=256)),
    "wav2vec2_group": lambda k: jw2v.init_wav2vec2(
        k, jcfg.Wav2Vec2Config(**_W2V)),
    "data2vec_bias": lambda k: jw2v.init_wav2vec2(
        k, jcfg.Wav2Vec2Config(**_W2V, feat_norm="layer", conv_bias=True,
                               pos_conv_mode="data2vec", pos_convs=2)),
}


@pytest.mark.parametrize("name", list(ZOO_TREES))
def test_zoo_tree_round_trip(name):
    tree = random_tree(ZOO_TREES[name])
    module = ParamTree(from_jax_params(tree, "cpu"))
    assert_round_trip(tree, module)
    if name == "r3d18":
        assert module["stages"][0][0]["down"] is None
        assert isinstance(module["stages"][1], torch.nn.ModuleList)
        assert len(list(module.parameters())) == 2 * (1 + 4 * 2 * 2 + 3)
    if name == "wav2vec2_group":
        assert "norm" in module["convs"][0] and "norm" not in module["convs"][1]
        assert "b" not in module["convs"][0]


def _kosmos_cfg(mod, **dec):
    return mod.KosmosConfig(
        decoder=mod.MagnetoConfig(vocab_size=97, embed_dim=32, ffn_dim=64,
                                  layers=2, heads=4, max_positions=512, **dec),
        vision=mod.VisionConfig(image_size=28, patch_size=14, hidden_dim=32,
                                layers=2, heads=4, mlp_dim=64),
        resampler=mod.ResamplerConfig(dim=32, depth=1, dim_head=8, heads=4,
                                      num_latents=8, num_media_embeds=5),
        image_embed_len=8)


@pytest.mark.parametrize("dec", [{}, {"moe_experts": 4, "multiway": False}],
                         ids=["kosmos", "kosmos_moe"])
def test_kosmos_tree_round_trip(dec):
    """The existing Kosmos trees, dense and MoE, still round-trip
    unchanged."""
    tree = random_tree(lambda k: JKosmos.init(k, _kosmos_cfg(jcfg, **dec)))
    model = TKosmos(_kosmos_cfg(tcfg, **dec),
                    params=from_jax_params(tree, "cpu"))
    assert_round_trip(tree, model)


def test_moe_decoder_tree_round_trip():
    cfg = jcfg.MagnetoConfig(vocab_size=97, embed_dim=32, ffn_dim=64,
                             layers=2, heads=4, moe_experts=4)
    tree = random_tree(lambda k: jdec.init_decoder(k, cfg))
    assert_round_trip(tree, ParamTree(from_jax_params(tree, "cpu")))


def test_param_count_bytes_and_paths():
    """``utils.pytree`` against kosmosx_tpu/utils/pytree.py on an r3d18 tree
    (lists of lists, ``None`` subtrees) with a bf16 leaf, as a nested tree
    and as a module."""
    from kosmosx_torch.utils import param_bytes, param_count
    from kosmosx_torch.utils.pytree import tree_paths
    from kosmosx_tpu.utils import pytree as jpytree

    tree = random_tree(ZOO_TREES["r3d18"])
    tree["stem"]["b"] = tree["stem"]["b"].astype(jnp.bfloat16)
    ttree = from_jax_params(tree, "cpu")
    for t in (ttree, ParamTree(ttree)):
        assert param_count(t) == jpytree.param_count(tree)
        assert param_bytes(t) == jpytree.param_bytes(tree)
        assert (sorted(p for p, _ in tree_paths(t))
                == sorted(p for p, _ in jpytree.tree_paths(tree)))
