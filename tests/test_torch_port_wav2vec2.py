"""kosmosx_torch's wav2vec2 / data2vec-audio encoder and the audio and video
converters against the JAX package.

The encoder runs at the JAX tests' small ``_W2V`` shape (hidden 32, 2
layers, convs of 16 channels) in its three modes (group norm with post-LN
layers, layer norm with pre-LN layers, data2vec's stacked positional
convs), each with an even and an odd positional kernel; JAX's parameters
are carried across with ``from_jax_params``. Every converter runs on the
same state dict in both packages and the trees agree leaf for leaf: HF
models where ``transformers`` is installed, and state dicts built here so
the converters are tested without it, under both weight-norm namings. The
r3d18 converter runs on the JAX test's torchvision-layout oracle with
random BatchNorm statistics. Bars: 1e-4 in fp32 (tests/test_torch_parity.py
:48), 2e-4 against a torch module (tests/test_hf_audio_video.py:66).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.core.params import ParamTree
from kosmosx_torch.nn import audio as taudio
from kosmosx_torch.nn import video as tvideo
from kosmosx_torch.nn import wav2vec2 as tw2v
from kosmosx_torch.utils import hf_convert as thf
from kosmosx_torch.utils.jax_params import from_jax_params, to_numpy_params
from kosmosx_tpu.nn import audio as jaudio
from kosmosx_tpu.nn import video as jvideo
from kosmosx_tpu.nn import wav2vec2 as jw2v
from kosmosx_tpu.utils import hf_convert as jhf
from test_hf_audio_video import _W2V, _R3D18, _randomize_bn_stats

TOL = dict(atol=1e-4, rtol=1e-4)
ORACLE_TOL = dict(atol=2e-4, rtol=2e-4)

J_W2V = jax.jit(jw2v.wav2vec2_encode, static_argnames=("cfg",))
J_VIDEO = jax.jit(jvideo.video_encoder, static_argnames=("cfg",))

MODES = {
    "group_postln": dict(feat_norm="group"),
    "layer_stable": dict(feat_norm="layer", stable_layer_norm=True),
    "data2vec": dict(feat_norm="layer", pos_conv_mode="data2vec",
                     pos_convs=2, conv_bias=True),
}


def w2v_cfg(mod, mode, kernel):
    return mod.Wav2Vec2Config(**{**_W2V, "pos_conv_kernel": kernel},
                              **MODES[mode])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_same_tree(got, want, **tol):
    """Same structure (dict keys, list lengths, None at the same places) and
    leaves within ``tol``."""
    if want is None:
        assert got is None
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same_tree(got[k], want[k], **tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_tree(g, w, **tol)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), **tol)


def port_tree(tree):
    """A converter's torch tree as numpy, through ``ParamTree``."""
    return to_numpy_params(ParamTree(tree))


@pytest.mark.parametrize("kernel", [16, 9], ids=["even", "odd"])
@pytest.mark.parametrize("mode", list(MODES))
def test_encoder_matches_jax(mode, kernel):
    jc, tc = w2v_cfg(jcfg, mode, kernel), w2v_cfg(tcfg, mode, kernel)
    params = _np_tree(jw2v.init_wav2vec2(jax.random.PRNGKey(0), jc))
    wav = np.random.default_rng(1).standard_normal((2, 400)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(J_W2V(params, jnp.asarray(wav), cfg=jc))
    tp = ParamTree(from_jax_params(params, "cpu"))
    out = tw2v.wav2vec2_encode(tp, torch.from_numpy(wav), tc)
    assert out.shape == ref.shape == (2, 39, 32)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert_same_tree(to_numpy_params(tp), params, atol=0, rtol=0)


def test_port_init_has_jax_tree_layout():
    """The port's own init gives JAX's tree: same keys, optional leaves and
    shapes, in every mode."""
    for mode in MODES:
        jt = _np_tree(jw2v.init_wav2vec2(jax.random.PRNGKey(0),
                                         w2v_cfg(jcfg, mode, 16)))
        tt = port_tree(tw2v.init_wav2vec2(
            torch.Generator().manual_seed(0), w2v_cfg(tcfg, mode, 16), "cpu"))
        assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(
            np.shape, tt)) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.shape, jt)))
        assert jax.tree_util.tree_map(np.shape, tt) == \
            jax.tree_util.tree_map(np.shape, jt)


def test_audio_dispatch_and_hidden_dim_guard():
    """``AudioConfig(arch="wav2vec2")`` runs the HF encoder (the JAX test
    test_audio_config_dispatch), and a hidden_dim that differs from the
    encoder's raises."""
    jc = jcfg.AudioConfig(arch="wav2vec2", hidden_dim=32,
                          w2v=jcfg.Wav2Vec2Config(**_W2V))
    tc = tcfg.AudioConfig(arch="wav2vec2", hidden_dim=32,
                          w2v=tcfg.Wav2Vec2Config(**_W2V))
    params = _np_tree(jaudio.init_audio_encoder(jax.random.PRNGKey(0), jc))
    wav = np.random.default_rng(2).standard_normal((1, 400)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jaudio.audio_encoder(params, jnp.asarray(wav), jc))
    out = taudio.audio_encoder(ParamTree(from_jax_params(params, "cpu")),
                               torch.from_numpy(wav), tc)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    with pytest.raises(ValueError, match="hidden_dim"):
        taudio.init_audio_encoder(
            torch.Generator().manual_seed(0),
            tcfg.AudioConfig(arch="wav2vec2", hidden_dim=64,
                             w2v=tcfg.Wav2Vec2Config(**_W2V)), "cpu")


# ---------------------------------------------------------------------------
# converters on HF models (transformers where installed)
# ---------------------------------------------------------------------------


def _hf_kwargs():
    return dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, conv_dim=(16, 16), conv_kernel=(10, 3),
                conv_stride=(5, 2), num_feat_extract_layers=2,
                hidden_dropout=0.0, attention_dropout=0.0,
                feat_proj_dropout=0.0, layerdrop=0.0)


@pytest.mark.parametrize("stable", [False, True], ids=["base", "stable"])
def test_wav2vec2_converter_on_hf_model(stable):
    transformers = pytest.importorskip("transformers")
    hf = transformers.Wav2Vec2Config(
        **_hf_kwargs(), num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4,
        feat_extract_norm="layer" if stable else "group",
        do_stable_layer_norm=stable)
    torch.manual_seed(0)
    model = transformers.Wav2Vec2Model(hf).eval()
    feat_norm = "layer" if stable else "group"
    got = thf.wav2vec2_params_from_hf(model, feat_norm=feat_norm)
    assert_same_tree(port_tree(got),
                     jhf.wav2vec2_params_from_hf(model, feat_norm=feat_norm),
                     atol=1e-6, rtol=1e-6)
    cfg = tcfg.Wav2Vec2Config(**_W2V, feat_norm=feat_norm,
                              stable_layer_norm=stable)
    wav = np.random.RandomState(1).randn(2, 400).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(wav)).last_hidden_state
    out = tw2v.wav2vec2_encode(ParamTree(got), torch.from_numpy(wav), cfg)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **ORACLE_TOL)


def test_data2vec_converter_on_hf_model():
    transformers = pytest.importorskip("transformers")
    hf = transformers.Data2VecAudioConfig(
        **_hf_kwargs(), conv_pos_kernel_size=9, num_conv_pos_embeddings=2,
        num_conv_pos_embedding_groups=4)
    torch.manual_seed(1)
    model = transformers.Data2VecAudioModel(hf).eval()
    got = thf.data2vec_audio_params_from_hf(model)
    assert len(got["pos_conv"]) == 2
    assert_same_tree(port_tree(got), jhf.data2vec_audio_params_from_hf(model),
                     atol=1e-6, rtol=1e-6)
    cfg = tcfg.Wav2Vec2Config(**{**_W2V, "pos_conv_kernel": 9},
                              feat_norm="layer", pos_conv_mode="data2vec",
                              pos_convs=2)
    wav = np.random.RandomState(2).randn(2, 400).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(wav)).last_hidden_state
    out = tw2v.wav2vec2_encode(ParamTree(got), torch.from_numpy(wav), cfg)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **ORACLE_TOL)


# ---------------------------------------------------------------------------
# converters on state dicts built here (no transformers needed)
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def hf_state_dict(params, pos_naming, prefix=""):
    """An HF-named state dict holding a JAX ``init_wav2vec2`` tree: conv
    kernels back to (out, in/g, k), linears to (out, in), and the
    positional conv as weight norm's ``g``/``v`` under ``pos_naming``
    ("parametrizations", "weight_g" or "plain"), or as data2vec's stacked
    layers where the tree holds more than one."""
    rng = np.random.default_rng(7)
    sd = {}

    def lin(p, name):
        sd[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
        sd[f"{name}.bias"] = _t(p["b"])

    def ln(p, name):
        sd[f"{name}.weight"] = _t(p["scale"])
        sd[f"{name}.bias"] = _t(p["bias"])

    for i, c in enumerate(params["convs"]):
        p = f"feature_extractor.conv_layers.{i}"
        sd[f"{p}.conv.weight"] = _t(np.asarray(c["w"]).transpose(2, 1, 0))
        if "b" in c:
            sd[f"{p}.conv.bias"] = _t(c["b"])
        if "norm" in c:
            ln(c["norm"], f"{p}.layer_norm")
    ln(params["feat_proj"]["ln"], "feature_projection.layer_norm")
    lin(params["feat_proj"], "feature_projection.projection")
    ln(params["enc_ln"], "encoder.layer_norm")
    pos = params["pos_conv"]
    if len(pos) == 1:
        conv = "encoder.pos_conv_embed.conv"
        v = np.asarray(pos[0]["w"]).transpose(2, 1, 0)  # (out, in/g, k)
        g = rng.uniform(0.5, 1.5, (1, 1, v.shape[2])).astype(np.float32)
        if pos_naming == "parametrizations":
            sd[f"{conv}.parametrizations.weight.original0"] = _t(g)
            sd[f"{conv}.parametrizations.weight.original1"] = _t(v)
        elif pos_naming == "weight_g":
            sd[f"{conv}.weight_g"] = _t(g)
            sd[f"{conv}.weight_v"] = _t(v)
        else:
            sd[f"{conv}.weight"] = _t(v)
        sd[f"{conv}.bias"] = _t(pos[0]["b"])
    else:
        for i, p in enumerate(pos):
            conv = f"encoder.pos_conv_embed.layers.{i}.conv"
            sd[f"{conv}.weight"] = _t(np.asarray(p["w"]).transpose(2, 1, 0))
            sd[f"{conv}.bias"] = _t(p["b"])
    for i, lp in enumerate(params["layers"]):
        p = f"encoder.layers.{i}"
        for n in ("q", "k", "v", "out"):
            lin(lp["attn"][n], f"{p}.attention.{n}_proj")
        ln(lp["ln1"], f"{p}.layer_norm")
        lin(lp["mlp"]["fc1"], f"{p}.feed_forward.intermediate_dense")
        lin(lp["mlp"]["fc2"], f"{p}.feed_forward.output_dense")
        ln(lp["ln2"], f"{p}.final_layer_norm")
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("naming", ["parametrizations", "weight_g", "plain"])
def test_wav2vec2_converter_weight_norm_namings(naming):
    """Both weight-norm namings fold to JAX's kernel; the ``wav2vec2.``
    prefix of a CTC wrapper is stripped; the converted tree runs as JAX's
    converted tree does."""
    jc = w2v_cfg(jcfg, "group_postln", 16)
    params = _np_tree(jw2v.init_wav2vec2(jax.random.PRNGKey(3), jc))
    sd = hf_state_dict(params, naming, prefix="wav2vec2.")
    want = jhf.wav2vec2_params_from_hf(sd)
    got = thf.wav2vec2_params_from_hf(sd)
    assert_same_tree(port_tree(got), want, atol=1e-6, rtol=1e-6)
    for leaf in jax.tree_util.tree_leaves(got):
        assert leaf.dtype == torch.float32 and leaf.is_contiguous()
    wav = np.random.default_rng(4).standard_normal((1, 400)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(J_W2V(want, jnp.asarray(wav), cfg=jc))
    out = tw2v.wav2vec2_encode(ParamTree(got), torch.from_numpy(wav),
                               w2v_cfg(tcfg, "group_postln", 16))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_data2vec_converter_on_state_dict():
    jc = w2v_cfg(jcfg, "data2vec", 9)
    params = _np_tree(jw2v.init_wav2vec2(jax.random.PRNGKey(5), jc))
    sd = hf_state_dict(params, "plain", prefix="data2vec_audio.")
    want = jhf.data2vec_audio_params_from_hf(sd)
    got = thf.data2vec_audio_params_from_hf(sd)
    assert len(got["pos_conv"]) == 2 and "b" in got["convs"][0]
    assert_same_tree(port_tree(got), want, atol=0, rtol=0)


def test_group_converter_needs_conv0_norm():
    params = _np_tree(jw2v.init_wav2vec2(jax.random.PRNGKey(3),
                                         w2v_cfg(jcfg, "layer_stable", 16)))
    sd = {k: v for k, v in hf_state_dict(params, "plain").items()
          if not k.startswith("feature_extractor.conv_layers.0.layer_norm")}
    with pytest.raises(KeyError, match="group"):
        thf.wav2vec2_params_from_hf(sd, feat_norm="group")


# ---------------------------------------------------------------------------
# r3d18 and the BatchNorm fold
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def r3d18_oracle():
    torch.manual_seed(4)
    oracle = _R3D18(widths=(8, 16, 32, 64)).eval()
    _randomize_bn_stats(oracle)
    return oracle


def test_r3d18_converter_and_encoder(r3d18_oracle):
    """The BatchNorm fold gives JAX's tree (``down`` None where a block has
    no downsampling conv), and the encoder on it matches the oracle and
    JAX's encoder on the same tree."""
    sd = r3d18_oracle.state_dict()
    want = jhf.r3d18_params_from_state_dict(sd)
    got = thf.r3d18_params_from_state_dict(r3d18_oracle)
    assert got["stages"][0][0]["down"] is None
    assert got["stages"][1][0]["down"] is not None
    assert_same_tree(port_tree(got), want, atol=1e-6, rtol=1e-6)
    clips = np.random.RandomState(5).randn(2, 3, 4, 32, 32).astype(np.float32)
    cfg = dataclasses.replace(tcfg.VideoConfig(arch="r3d18"), hidden_dim=64)
    jc = dataclasses.replace(jcfg.VideoConfig(arch="r3d18"), hidden_dim=64)
    with torch.no_grad():
        ref = r3d18_oracle(torch.from_numpy(clips)).numpy()
    with jax.default_matmul_precision("highest"):
        jout = np.asarray(J_VIDEO(want, jnp.asarray(clips), cfg=jc))
    out = tvideo.video_encoder(ParamTree(got), torch.from_numpy(clips),
                               cfg).numpy()
    assert out.shape == ref.shape == (2, 64)
    np.testing.assert_allclose(out, ref, **ORACLE_TOL)
    np.testing.assert_allclose(out, jout, **ORACLE_TOL)


def test_bn_fold_with_conv_bias():
    """A conv with its own bias: the fold scales it too, as JAX's does."""
    rng = np.random.default_rng(6)
    sd = {"c.weight": _t(rng.standard_normal((4, 3, 1, 3, 3))),
          "c.bias": _t(rng.standard_normal(4)),
          "n.weight": _t(rng.uniform(0.5, 1.5, 4)),
          "n.bias": _t(rng.standard_normal(4)),
          "n.running_mean": _t(rng.standard_normal(4)),
          "n.running_var": _t(rng.uniform(0.5, 1.5, 4))}
    got = thf._fold_bn_into_conv3d(sd, "c", "n")
    want = jhf._fold_bn_into_conv3d(sd, "c", "n")
    assert tuple(got["w"].shape) == (1, 3, 3, 3, 4)
    assert_same_tree({k: v.numpy() for k, v in got.items()}, want,
                     atol=1e-6, rtol=1e-6)
