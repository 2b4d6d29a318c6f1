"""kosmosx_torch's modality zoo against the JAX package: the counterpart of
every test in tests/test_modalities.py.

Framed audio, the lean and r3d18 video towers, ``KosmosConditional`` (all
modalities, text only, only the requested towers, the assertion on a
missing tower, padding segment ids, decorrelated dropout keys), the
detector, ``KosmosAny`` (registration, a pure ``apply`` with gradients
against ``jax.grad`` in every registered tower) and the tokenizer's
modality tags. JAX parameters are carried across with ``from_jax_params``,
inputs come from numpy with a seed, and the JAX models are built once per
module. Bar: 1e-4 in fp32 (tests/test_torch_parity.py:48); 2e-4 for r3d18
with JAX at matmul precision "highest" (tests/test_hf_audio_video.py:196).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.core.params import ParamTree, to_tree
from kosmosx_torch.data.tokenizer import KosmosTokenizer as TTokenizer
from kosmosx_torch.models.any_modality import KosmosAny as TAny
from kosmosx_torch.models.any_modality import ModalityDetector as TDetector
from kosmosx_torch.models.conditional import KosmosConditional as TCond
from kosmosx_torch.nn import audio as taudio
from kosmosx_torch.nn import decoder as tdec
from kosmosx_torch.nn import video as tvideo
from kosmosx_torch.utils.jax_params import from_jax_params, to_numpy_params
from kosmosx_tpu.data.tokenizer import KosmosTokenizer as JTokenizer
from kosmosx_tpu.models.any_modality import KosmosAny as JAny
from kosmosx_tpu.models.any_modality import ModalityDetector as JDetector
from kosmosx_tpu.models.conditional import KosmosConditional as JCond
from kosmosx_tpu.nn import audio as jaudio
from kosmosx_tpu.nn import video as jvideo

TOL = dict(atol=1e-4, rtol=1e-4)
# jitted JAX entry points: op-by-op dispatch of the same code is much slower
J_AUDIO = jax.jit(jaudio.audio_encoder, static_argnames=("cfg",))
J_VIDEO = jax.jit(jvideo.video_encoder, static_argnames=("cfg",))


def configs(mod):
    """tests/test_modalities.py's shapes, in ``mod``'s config classes."""
    return dict(
        decoder=mod.MagnetoConfig(
            vocab_size=512, embed_dim=64, ffn_dim=128, layers=2, heads=4,
            max_positions=256, use_flash_attention=False, multiway=False,
            dropout=0.0),
        audio=mod.AudioConfig(hidden_dim=32, layers=1, heads=4, mlp_dim=64,
                              conv_widths=(16, 16)),
        video=mod.VideoConfig(hidden_dim=64, frame_size=32),
        vision=mod.VisionConfig(image_size=28, patch_size=14, hidden_dim=32,
                                layers=1, heads=2, mlp_dim=64,
                                use_flash_attention=False),
        resampler=mod.ResamplerConfig(dim=32, depth=1, dim_head=8, heads=4,
                                      num_latents=4, num_media_embeds=4))


J, T = configs(jcfg), configs(tcfg)
ALL = ("text", "image", "audio", "video")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(tree):
    return from_jax_params(_np_tree(tree), "cpu")


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape):
    return _rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(seed, b, l):
    return _rng(seed).integers(4, 512, (b, l)).astype(np.int32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def shapes(tree):
    return jax.tree_util.tree_map(np.shape, tree)


def port_tower(init_fn, jinit_fn, cfg_t, cfg_j, seed=0):
    """A tower from the port's seeded init, as a ``ParamTree`` and as the
    numpy tree JAX runs (a port init is far cheaper than an op-by-op JAX
    one); its layout is JAX's init's, traced with ``jax.eval_shape``."""
    tp = ParamTree(init_fn(_gen(seed), cfg_t, "cpu"))
    tree = to_numpy_params(tp)
    want = jax.eval_shape(lambda k: jinit_fn(k, cfg_j), jax.random.PRNGKey(0))
    assert shapes(tree) == jax.tree_util.tree_map(lambda s: s.shape, want)
    return tp, tree


@pytest.mark.parametrize("arch", ["framed"])
def test_audio_encoder(arch):
    cfg_j, cfg_t = J["audio"], T["audio"]
    tp, params = port_tower(taudio.init_audio_encoder,
                            jaudio.init_audio_encoder, cfg_t, cfg_j)
    wav = _normal(1, (2, 1030))  # 6 samples past the last whole frame
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(J_AUDIO(params, jnp.asarray(wav), cfg=cfg_j))
    out = taudio.audio_encoder(tp, torch.from_numpy(wav), cfg_t)
    assert out.shape == ref.shape == (2, 1024 // (8 * 4), 32)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_frame_strides_guard():
    with pytest.raises(ValueError, match="framing strides"):
        taudio.frame_strides(tcfg.AudioConfig(conv_widths=(8,) * 4))


@pytest.mark.parametrize("hidden,shape", [
    (64, (2, 3, 4, 32, 32)),        # the JAX test's clip
    (256, (1, 3, 5, 33, 30)),       # odd sizes; block 3 subsamples its skip
], ids=["lean64", "lean256_odd"])
def test_lean_video_encoder(hidden, shape):
    """XLA "SAME" padding at stride 2 (asymmetric) through explicit pads."""
    cfg_j = jcfg.VideoConfig(hidden_dim=hidden, frame_size=32)
    cfg_t = tcfg.VideoConfig(hidden_dim=hidden, frame_size=32)
    tp, params = port_tower(tvideo.init_video_encoder,
                            jvideo.init_video_encoder, cfg_t, cfg_j)
    clips = _normal(1, shape)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(J_VIDEO(params, jnp.asarray(clips), cfg=cfg_j))
    if hidden == 256:
        assert tp["blocks"][3]["skip"] is None
    out = tvideo.video_encoder(tp, torch.from_numpy(clips), cfg_t)
    assert out.shape == ref.shape == (shape[0], hidden)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_r3d18_video_encoder():
    """r3d18 at its real widths (64-512): ``down`` None in the blocks
    without a downsampling conv."""
    cfg_j, cfg_t = (jcfg.VideoConfig(arch="r3d18"),
                    tcfg.VideoConfig(arch="r3d18"))
    tp, params = port_tower(tvideo.init_video_encoder,
                            jvideo.init_video_encoder, cfg_t, cfg_j, seed=2)
    assert params["stages"][0][0]["down"] is None
    clips = _normal(3, (1, 3, 4, 24, 24))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(J_VIDEO(params, jnp.asarray(clips), cfg=cfg_j))
    out = tvideo.video_encoder(tp, torch.from_numpy(clips), cfg_t)
    assert out.shape == (1, 512)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match="512"):
        tvideo.init_video_encoder(torch.Generator().manual_seed(0),
                                  tcfg.VideoConfig(arch="r3d18", hidden_dim=64),
                                  "cpu")


# ---------------------------------------------------------------------------
# KosmosConditional
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tcond():
    return TCond(ALL, generator=_gen(0), device="cpu", **T)


@pytest.fixture(scope="module")
def jcond(tcond):
    """JAX's model on the port's weights."""
    return JCond(modalities=ALL, params=to_numpy_params(tcond), **J)


@pytest.fixture(scope="module")
def jcond_apply(jcond):
    return jax.jit(jcond.apply, static_argnames=("use_padding_mask",))


@pytest.fixture(scope="module")
def cond_inputs():
    toks = _tokens(1, 2, 10)
    toks[1, 7:] = 1  # padding_idx: row 1 right-padded
    return dict(toks=toks, images=_normal(2, (2, 3, 28, 28)),
                audios=_normal(3, (2, 512)),
                videos=_normal(4, (2, 3, 4, 32, 32)))


def test_conditional_builds_only_requested_towers():
    m = TCond(("text", "audio"), decoder=T["decoder"], audio=T["audio"],
              generator=torch.Generator().manual_seed(0), device="cpu")
    assert "audio_enc" in m and "clip" not in m and "video_enc" not in m
    assert m.modalities == ("text", "audio")
    with pytest.raises(AssertionError):
        m(torch.ones((1, 8), dtype=torch.long),
          images=torch.zeros((1, 3, 28, 28)))
    with pytest.raises(ValueError, match="unknown"):
        TCond(("text", "smell"), decoder=T["decoder"],
              generator=torch.Generator().manual_seed(0), device="cpu")


def test_conditional_tree_is_jax_tree(jcond, tcond):
    """The port's init has JAX's init's layout; a JAX tree carried across
    with ``from_jax_params`` builds the same module."""
    want = jax.eval_shape(lambda k: JCond(modalities=ALL, **J).init(k),
                          jax.random.PRNGKey(0))
    assert shapes(jcond.params) == jax.tree_util.tree_map(lambda s: s.shape,
                                                          want)
    assert tcond.num_params == jcond.num_params
    carried = TCond(ALL, params=_carry(jcond.params), **T)
    assert (sorted((n, tuple(p.shape)) for n, p in carried.named_parameters())
            == sorted((n, tuple(p.shape)) for n, p in tcond.named_parameters()))


@pytest.mark.parametrize("padding_mask", [True, False],
                         ids=["padding_mask", "no_mask"])
def test_conditional_forward_all_modalities(jcond, jcond_apply, tcond,
                                            cond_inputs, padding_mask):
    """4 latents (image) + 1 audio + 1 video spliced after BOS; a
    right-padded row under the padding mask."""
    x = cond_inputs
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jcond_apply(
            jcond.params, jnp.asarray(x["toks"]),
            images=jnp.asarray(x["images"]), audios=jnp.asarray(x["audios"]),
            videos=jnp.asarray(x["videos"]), use_padding_mask=padding_mask))
    with torch.no_grad():
        out = tcond(torch.from_numpy(x["toks"]),
                    images=torch.from_numpy(x["images"]),
                    audios=torch.from_numpy(x["audios"]),
                    videos=torch.from_numpy(x["videos"]),
                    use_padding_mask=padding_mask)
    assert out.shape == ref.shape == (2, 10 + 4 + 1 + 1, 512)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_conditional_text_only_and_subsets(jcond, jcond_apply, tcond,
                                           cond_inputs):
    """Text only, and audio alone, on the same model."""
    x = cond_inputs
    toks = jnp.asarray(x["toks"])
    with jax.default_matmul_precision("highest"):
        ref_text = np.asarray(jcond_apply(jcond.params, toks))
        ref_audio = np.asarray(jcond_apply(jcond.params, toks,
                                           audios=jnp.asarray(x["audios"])))
    with torch.no_grad():
        out_text = tcond(torch.from_numpy(x["toks"]))
        out_audio = tcond(torch.from_numpy(x["toks"]),
                          audios=torch.from_numpy(x["audios"]))
    assert out_text.shape == (2, 10, 512) and out_audio.shape == (2, 11, 512)
    np.testing.assert_allclose(out_text.numpy(), ref_text, **TOL)
    np.testing.assert_allclose(out_audio.numpy(), ref_audio, **TOL)


def test_conditional_dropout_rng_decorrelated(monkeypatch):
    """The embedding's dropout key and the layers' differ."""
    cfg = dataclasses.replace(T["decoder"], dropout=0.5,
                              attention_dropout=0.0)
    m = TCond(("text",), decoder=cfg,
              generator=torch.Generator().manual_seed(0), device="cpu")
    seen = {}
    fe, rl = tdec.forward_embedding, tdec.run_layers

    def spy_fe(*a, rng=None, **kw):
        seen["embed"] = rng
        return fe(*a, rng=rng, **kw)

    def spy_rl(*a, rng=None, **kw):
        seen["layers"] = rng
        return rl(*a, rng=rng, **kw)

    monkeypatch.setattr(tdec, "forward_embedding", spy_fe)
    monkeypatch.setattr(tdec, "run_layers", spy_rl)
    toks = torch.ones((1, 16), dtype=torch.long)
    a = m(toks, rng=7)
    assert seen["embed"] is not None and seen["layers"] is not None
    assert seen["embed"] != seen["layers"]
    assert torch.equal(a, m(toks, rng=7))
    assert not torch.equal(a, m(toks, rng=8))


# ---------------------------------------------------------------------------
# the detector and KosmosAny
# ---------------------------------------------------------------------------


def test_modality_detector():
    det, jdet = TDetector(), JDetector()
    cases = [(("hello",), {}), ((np.zeros((1, 3, 32, 32)),), {}),
             ((np.zeros((1, 3, 4, 32, 32)),), {}), ((np.zeros((1, 1000)),), {}),
             ((None,), {"path": "x/cat.png"}), ((None,), {"path": "a.wav"}),
             ((None,), {"path": "v.mp4"}), ((None,), {"path": "n.md"}),
             ((np.zeros((1, 5, 7)),), {}),
             ((np.zeros((1, 3, 32, 32)),), {"user_modality": "any"})]
    got = [det.detect(*a, **kw) for a, kw in cases]
    assert got == [jdet.detect(*a, **kw) for a, kw in cases]
    assert got == ["text", "image", "video", "audio", "image", "audio",
                   "video", "text", "any", "any"]
    assert det.detect(torch.zeros(1, 3, 4, 32, 32)) == "video"


def any_models(media, seed=0):
    """JAX's KosmosAny with image and audio towers of the JAX test's shapes,
    ``media`` registered; the port's, carried across, registered the same
    way."""
    jm = JAny(decoder=J["decoder"], seed=seed)
    jm.configs["image"] = (J["vision"], J["resampler"])
    jm.configs["audio"] = J["audio"]
    jprep = jm.prepare_media(media)
    tm = TAny(T["decoder"], params=_carry(jm.params), device="cpu")
    tm.configs["image"] = (T["vision"], T["resampler"])
    tm.configs["audio"] = T["audio"]
    tprep = tm.prepare_media(media)
    return jm, jprep, tm, tprep


MEDIA = [(None, _normal(5, (1, 3, 28, 28))),
         ("audio", _normal(6, (1, 512))),
         ("any", _normal(7, (1, 5, 7)))]


@pytest.fixture(scope="module")
def anys():
    return any_models(MEDIA)


def jax_any_apply(jm, prep):
    """``jm.apply`` jitted over (params, tokens, arrays) for the modalities
    of ``prep``."""
    mods = [m for m, _ in prep]
    return jax.jit(lambda p, t, xs: jm.apply(p, t, media=list(zip(mods, xs))))


def test_kosmos_any_lazy_encoders():
    """Text only builds nothing; an image registers the image tower alone;
    then audio; logits as JAX's on the carried tree."""
    m = TAny(T["decoder"], generator=torch.Generator().manual_seed(0),
             device="cpu")
    m.configs["image"] = (T["vision"], T["resampler"])
    m.configs["audio"] = T["audio"]
    base = m.num_params
    toks = torch.from_numpy(_tokens(1, 1, 8))
    assert m(toks).shape == (1, 8, 512) and m.num_params == base
    img = np.zeros((1, 3, 28, 28), np.float32)
    assert m(toks, media=[(None, img)]).shape == (1, 8 + 4, 512)
    assert "image_enc" in m and m.num_params > base and "audio_enc" not in m
    out = m(toks, media=[(None, img), ("audio", np.zeros((1, 512), np.float32))])
    assert out.shape == (1, 8 + 4 + 1, 512) and "audio_enc" in m
    for _, p in m.named_parameters():
        assert p.device.type == "cpu"


def test_kosmos_any_forward_matches_jax(anys):
    jm, jprep, tm, tprep = anys
    assert [mod for mod, _ in tprep] == ["image", "audio", "any"]
    for (_, a), (_, b) in zip(jprep, tprep):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    toks = _tokens(2, 1, 8)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_any_apply(jm, jprep)(
            jm.params, jnp.asarray(toks), [x for _, x in jprep]))
    with torch.no_grad():
        out = tm.apply(torch.from_numpy(toks), media=tprep)
    assert out.shape == ref.shape == (1, 8 + 4 + 1 + 1, 512)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_kosmos_any_pure_apply_trains(anys):
    """``apply`` adds no parameter; the gradient of mean(logits**2) reaches
    every registered tower and matches ``jax.grad``, each leaf within 1e-4
    of its tower's largest gradient (attention's key biases have gradients
    that are zero but for rounding); an unregistered modality raises
    ``KeyError``."""
    jm, jprep, tm, tprep = anys
    toks = np.ones((1, 8), np.int32)
    names = [n for n, _ in tm.named_parameters()]

    apply = jax_any_apply(jm, jprep)

    def jloss(p):
        return jnp.mean(apply(p, jnp.asarray(toks), [x for _, x in jprep]) ** 2)

    with jax.default_matmul_precision("highest"):
        jgrads = jax.jit(jax.grad(jloss))(jm.params)
    tm.set_trainable()
    try:
        loss = tm.apply(torch.from_numpy(toks), media=tprep).square().mean()
        loss.backward()
    finally:
        tm.set_trainable(freeze=[k for k in tm._modules])
    assert [n for n, _ in tm.named_parameters()] == names
    for top in ("decoder", "image_enc", "image_proj", "audio_enc",
                "audio_proj", "any_proj_35"):
        assert top in tm
    flat = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    jflat = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(g) for path, g in flat.items()}
    tower_max = {}
    for name, g in jflat.items():
        top = name.split(".")[0]
        tower_max[top] = max(tower_max.get(top, 0.0), float(np.abs(g).max()))
    for name, p in tm.named_parameters():
        if p.grad is None:  # a leaf off the path (the CLIP post-LN)
            assert not np.any(jflat[name]), name
            continue
        np.testing.assert_allclose(
            p.grad.numpy(), jflat[name], rtol=1e-4,
            atol=1e-4 * tower_max[name.split(".")[0]], err_msg=name)
        p.grad = None
    assert float(np.abs(jflat["image_proj.w"]).max()) > 0
    assert float(np.abs(jflat["any_proj_35.w"]).max()) > 0
    with pytest.raises(KeyError):
        tm.apply(torch.from_numpy(toks),
                 media=[("video", torch.zeros(1, 3, 4, 32, 32))])


def test_kosmos_any_registration_rules():
    """"any" needs ``any_dim``; a second "any" width adds its own
    projection; a carried tree without a tower and no generator raises."""
    m = TAny(T["decoder"], generator=torch.Generator().manual_seed(1),
             device="cpu")
    with pytest.raises(ValueError, match="any_dim"):
        m.register_modality("any")
    m.register_modality("any", any_dim=35)
    m.register_modality("any", any_dim=12)
    assert "any_proj_35" in m and "any_proj_12" in m
    out = m.apply(torch.ones((1, 4), dtype=torch.long),
                  media=[("any", torch.ones(1, 3, 4))])
    assert out.shape == (1, 5, 512)
    with pytest.raises(KeyError, match="never registered"):
        m.apply(torch.ones((1, 4), dtype=torch.long),
                media=[("any", torch.ones(1, 9))])
    carried = TAny(T["decoder"], params={"decoder": to_tree(m["decoder"])})
    with pytest.raises(ValueError, match="generator"):
        carried.register_modality("video")


# ---------------------------------------------------------------------------
# the tokenizer's modality tags
# ---------------------------------------------------------------------------


def test_tokenizer_multimodal_tags():
    kw = dict(use_hf=False, modalities=("image", "audio", "video", "any"))
    tok, jtok = TTokenizer(**kw), JTokenizer(**kw)
    spliced, raw = tok.tokenize_texts(["hi"], modalities=("image", "audio"))
    jspliced, jraw = jtok.tokenize_texts(["hi"], modalities=("image", "audio"))
    np.testing.assert_array_equal(np.asarray(spliced), np.asarray(jspliced))
    np.testing.assert_array_equal(np.asarray(raw), np.asarray(jraw))
    assert spliced.shape[1] == raw.shape[1] + 4
    assert spliced[0, 0] == tok.bos_token_id
    assert [int(t) for t in spliced[0, 1:5]] == [
        tok._tag_ids[t] for t in ("<image>", "</image>", "<audio>", "</audio>")]


def test_tokenizer_sample_assembly_and_roundtrip():
    tok = TTokenizer(use_hf=False, image_embed_len=8)
    jtok = JTokenizer(use_hf=False, image_embed_len=8)
    sample = {"target_text": "a cat",
              "image": np.zeros((1, 3, 64, 64), np.uint8)}
    out, jout = tok.tokenize(sample), jtok.tokenize(sample)
    b, l = out["text_tokens"].shape
    assert out["attention_mask"].shape == (b, l + 8)
    assert out["images"].shape == (1, 3, 224, 224)
    assert tok.decode(out["labels"][0]) == "a cat"
    for k in ("text_tokens", "attention_mask", "labels"):
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(jout[k]))
    np.testing.assert_allclose(np.asarray(out["images"]),
                               np.asarray(jout["images"]), **TOL)


def test_entry_points_default_to_the_card():
    """With no ``device``, the models build on the card: a CPU generator
    is refused before anything is drawn."""
    for build in (lambda g: TCond(("text",), decoder=T["decoder"], generator=g),
                  lambda g: TAny(T["decoder"], generator=g)):
        with pytest.raises(ValueError, match="generator lies on cpu"):
            build(_gen(0))
