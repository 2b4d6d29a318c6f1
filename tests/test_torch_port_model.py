"""kosmosx_torch modules and the Kosmos forward against the JAX package.

JAX parameters are carried across with ``from_jax_params``; the same numpy
inputs go through both packages. JAX runs at fp32 with matmul precision
"highest" and ``interpret=True`` where it reaches a Pallas kernel; the port
runs its plain kernel versions on the CPU. Bar: 1e-4
(tests/test_torch_parity.py:48). Shapes are small: decoder 2 layers, d 32,
4 heads, vocab 97; ViT on 28x28 with patch 14 (5 tokens), hidden 32,
2 layers; resampler with 8 latents and depth 1.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.core.params import ParamTree
from kosmosx_torch.models.kosmos import Kosmos as TKosmos
from kosmosx_torch.models.language import KosmosLanguage as TLanguage
from kosmosx_torch.nn import attention as tattn
from kosmosx_torch.nn import decoder as tdec
from kosmosx_torch.utils.jax_params import from_jax_params
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.nn import attention as jattn
from kosmosx_tpu.nn import decoder as jdec

TOL = dict(atol=1e-4, rtol=1e-4)
# jitted JAX entry points: op-by-op dispatch of the same code is ~10x slower
J_KOSMOS_APPLY = jax.jit(JKosmos.apply, static_argnames=(
    "cfg", "use_padding_mask", "interpret"))
J_DECODER_FORWARD = jax.jit(jdec.decoder_forward,
                            static_argnames=("cfg", "interpret"))


def dec_cfg(mod, **kw):
    base = dict(vocab_size=97, embed_dim=32, ffn_dim=64, layers=2, heads=4,
                max_positions=512, compute_dtype="float32", dropout=0.0,
                attention_dropout=0.0, multiway=True, subln=True,
                xpos_rel_pos=True)
    base.update(kw)
    return mod.MagnetoConfig(**base)


def kosmos_cfg(mod, **dec_kw):
    return mod.KosmosConfig(
        decoder=dec_cfg(mod, **dec_kw),
        vision=mod.VisionConfig(image_size=28, patch_size=14, hidden_dim=32,
                                layers=2, heads=4, mlp_dim=64),
        resampler=mod.ResamplerConfig(dim=32, depth=1, dim_head=8, heads=4,
                                      num_latents=8, num_media_embeds=5),
        image_embed_len=8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(x):
    return np.asarray(x, np.float32)


def _tokens(rng, b, l, vocab=97):
    return rng.integers(4, vocab, (b, l)).astype(np.int32)


@pytest.mark.parametrize("length", [17, 256], ids=["plain", "flash"])
def test_self_attention_full_sequence(length):
    params = jattn.init_self_attention(jax.random.PRNGKey(0), 32, 4,
                                       multiway=True)
    x = np.random.default_rng(0).standard_normal((2, length, 32)).astype(
        np.float32)
    kw = dict(heads=4, multiway=True, xpos=True, use_flash=True)
    with jax.default_matmul_precision("highest"):
        ref, _ = jax.jit(lambda p_, x_: jattn.self_attention(
            p_, x_, interpret=True, **kw))(params, jnp.asarray(x))
    out = tattn.self_attention(ParamTree(from_jax_params(_np_tree(params))),
                               torch.from_numpy(x), **kw)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("decode_kernel", [False, True],
                         ids=["plain", "decode_kernel"])
def test_self_attention_cache_branch(decode_kernel):
    """Prefill of a right-padded chunk into the cache at index 0, then one
    decode step per row at its own cache index: outputs and caches match."""
    params = jattn.init_self_attention(jax.random.PRNGKey(1), 32, 4,
                                       multiway=True)
    tparams = ParamTree(from_jax_params(_np_tree(params)))
    rng = np.random.default_rng(1)
    b, l, lmax = 3, 12, 24
    lengths = np.array([12, 7, 9], np.int32)
    seg = np.where(np.arange(l)[None] < lengths[:, None], 0, -1).astype(np.int32)
    x = rng.standard_normal((b, l, 32)).astype(np.float32)
    x1 = rng.standard_normal((b, 1, 32)).astype(np.float32)
    kw = dict(heads=4, multiway=True, xpos=True, use_flash=True,
              decode_attn_kernel=decode_kernel)
    zeros = np.zeros((b, 4, lmax, 8), np.float32)
    prefill = jax.jit(lambda p_, x_, c_, seg_: jattn.self_attention(
        p_, x_, cache=c_, cache_index=jnp.zeros(b, jnp.int32), prefill=True,
        segment_ids=seg_, interpret=True, **kw))
    step = jax.jit(lambda p_, x_, c_, idx_: jattn.self_attention(
        p_, x_, cache=c_, cache_index=idx_, interpret=True, **kw))
    with jax.default_matmul_precision("highest"):
        cache = {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)}
        p_ref, cache = prefill(params, jnp.asarray(x), cache, jnp.asarray(seg))
        d_ref, cache = step(params, jnp.asarray(x1), cache, jnp.asarray(lengths))
    tcache = {"k": torch.zeros(b, 4, lmax, 8), "v": torch.zeros(b, 4, lmax, 8)}
    p_out = tattn.self_attention(tparams, torch.from_numpy(x), cache=tcache,
                                 cache_index=0, prefill=True,
                                 segment_ids=torch.from_numpy(seg), **kw)
    d_out = tattn.self_attention(tparams, torch.from_numpy(x1), cache=tcache,
                                 cache_index=torch.from_numpy(lengths), **kw)
    for r, n in enumerate(lengths):  # padded prompt rows are discarded
        np.testing.assert_allclose(p_out[r, :n].numpy(), _np(p_ref)[r, :n],
                                   **TOL)
    np.testing.assert_allclose(d_out.numpy(), _np(d_ref), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), _np(cache["k"]), **TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), _np(cache["v"]), **TOL)


@pytest.mark.parametrize("length", [17, 256], ids=["plain", "flash"])
def test_decoder_forward(length):
    cfg_j, cfg_t = dec_cfg(jcfg), dec_cfg(tcfg)
    params = jdec.init_decoder(jax.random.PRNGKey(2), cfg_j)
    toks = _tokens(np.random.default_rng(2), 2, length)
    with jax.default_matmul_precision("highest"):
        ref = J_DECODER_FORWARD(params, jnp.asarray(toks), cfg_j,
                                interpret=True)
    model = TLanguage(cfg_t, params=from_jax_params(_np_tree(params)))
    out = model.apply(torch.from_numpy(toks).long())
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


@pytest.fixture(scope="module")
def kosmos_pair():
    cfg_j, cfg_t = kosmos_cfg(jcfg), kosmos_cfg(tcfg)
    params = JKosmos.init(jax.random.PRNGKey(3), cfg_j)
    return cfg_j, params, TKosmos(cfg_t, params=from_jax_params(_np_tree(params)))


@pytest.mark.parametrize("text_len,padding_mask",
                         [(10, False), (10, True), (250, False)],
                         ids=["plain", "padding_mask", "flash"])
def test_kosmos_apply(kosmos_pair, text_len, padding_mask):
    """Logits at a spliced length below 256 (plain attention) and at 258
    (flash path), on the bridged weights."""
    cfg_j, params, model = kosmos_pair
    rng = np.random.default_rng(4)
    toks = _tokens(rng, 2, text_len)
    if padding_mask:
        toks[1, 6:] = cfg_j.decoder.padding_idx
    images = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = J_KOSMOS_APPLY(params, jnp.asarray(toks), jnp.asarray(images),
                             cfg_j, use_padding_mask=padding_mask,
                             interpret=True)
    out = model.apply(torch.from_numpy(toks).long(), torch.from_numpy(images),
                      use_padding_mask=padding_mask)
    assert out.shape == (2, text_len + 8, 97)
    if padding_mask:  # padded query rows are discarded (sampler.py:118-120)
        np.testing.assert_allclose(out[0].numpy(), _np(ref)[0], **TOL)
        np.testing.assert_allclose(out[1, :6 + 8].numpy(),
                                   _np(ref)[1, :6 + 8], **TOL)
    else:
        np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_kosmos_multi_image(kosmos_pair):
    """Two images per row through the default multi-image splice."""
    cfg_j, params, model = kosmos_pair
    rng = np.random.default_rng(5)
    toks = _tokens(rng, 2, 9)
    images = rng.standard_normal((2, 2, 3, 28, 28)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = J_KOSMOS_APPLY(params, jnp.asarray(toks), jnp.asarray(images),
                             cfg_j, interpret=True)
    out = model.apply(torch.from_numpy(toks).long(), torch.from_numpy(images))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("scan_layers", [False, True], ids=["list", "stacked"])
def test_weight_bridge_layouts(scan_layers):
    """The list and the stacked (L, ...) layer layouts load into the same
    per-layer modules, named by JAX tree path, and compute what JAX does."""
    cfg_j = dec_cfg(jcfg, scan_layers=scan_layers)
    params = jdec.init_decoder(jax.random.PRNGKey(6), cfg_j)
    model = TLanguage(dec_cfg(tcfg), params=from_jax_params(_np_tree(params)))
    names = dict(model.named_parameters())
    w = names["layers.1.attn.q.A.w"]
    jw = params["layers"]["attn"]["q"]["A"]["w"][1] if scan_layers else \
        params["layers"][1]["attn"]["q"]["A"]["w"]
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert len(model["layers"]) == 2 and "ffn.B.fc2.b" in dict(
        model["layers"][0].named_parameters())
    toks = _tokens(np.random.default_rng(6), 1, 11)
    with jax.default_matmul_precision("highest"):
        ref = J_DECODER_FORWARD(params, jnp.asarray(toks), cfg_j)
    np.testing.assert_allclose(model.apply(torch.from_numpy(toks).long()).numpy(),
                               _np(ref), **TOL)


def test_kosmos_random_init_names_and_shapes():
    """Random init on a seeded generator builds the JAX tree: same paths,
    same shapes."""
    cfg_j, cfg_t = kosmos_cfg(jcfg), kosmos_cfg(tcfg)
    jshapes = {
        ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_leaves_with_path(
            JKosmos.init(jax.random.PRNGKey(0), cfg_j))}
    model = TKosmos(cfg_t, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    tshapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert tshapes == jshapes


MODEL_BUILDERS = {
    "Kosmos": lambda **kw: TKosmos(kosmos_cfg(tcfg), **kw),
    "KosmosLanguage": lambda **kw: TLanguage(dec_cfg(tcfg), **kw),
}


@pytest.mark.parametrize("model", sorted(MODEL_BUILDERS))
def test_model_builds_on_the_card_by_default(model):
    """Without a device the model is built on the card: a CPU generator then
    raises, saying where each lies (there is no CPU fallback)."""
    with pytest.raises(ValueError, match="generator lies on cpu .* built on "
                                         "cuda"):
        MODEL_BUILDERS[model](generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("model", sorted(MODEL_BUILDERS))
def test_model_generator_device_mismatch_raises(model):
    """A generator on another device than the one asked for raises; one on
    the device asked for builds there."""
    with pytest.raises(ValueError, match="generator lies on cpu"):
        MODEL_BUILDERS[model](generator=torch.Generator().manual_seed(0),
                              device="cuda")
    built = MODEL_BUILDERS[model](generator=torch.Generator().manual_seed(0),
                                  device="cpu")
    assert {p.device.type for p in built.parameters()} == {"cpu"}


@pytest.mark.parametrize("name", ["MagnetoConfig", "VisionConfig",
                                  "ResamplerConfig", "KosmosConfig"])
def test_config_mirror(name):
    """Same fields with the same defaults as the JAX dataclasses."""
    fj = [(f.name, f.default) for f in dataclasses.fields(getattr(jcfg, name))]
    ft = [(f.name, f.default) for f in dataclasses.fields(getattr(tcfg, name))]
    assert [n for n, _ in ft] == [n for n, _ in fj]
    for (n, dj), (_, dt) in zip(fj, ft):
        if dataclasses.is_dataclass(dj):
            dj, dt = dataclasses.asdict(dj), dataclasses.asdict(dt)
        assert dj == dt, n


def test_import_leaves_jax_out():
    code = ("import sys, kosmosx_torch, kosmosx_torch.utils.jax_params, "
            "kosmosx_torch.train, kosmosx_torch.train.trainer, "
            "kosmosx_torch.ops.roofline, kosmosx_torch.utils.timing, "
            "kosmosx_torch.studies.tile_rate_study; "
            "bad = [m for m in sys.modules if m in ('jax', 'optax') or "
            "m.startswith(('jax.', 'optax.', 'kosmosx_tpu', 'benchmarks'))]; "
            "print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _feature_calls(tmp_path):
    from kosmosx_torch.train import checkpoint as tckpt
    from kosmosx_torch.train.trainer import TrainConfig, Trainer

    cfg = dec_cfg(tcfg)
    small = ParamTree(tattn.init_self_attention(torch.Generator(), 32, 4))
    x = torch.zeros(1, 3, 32)
    cache = {"k": torch.zeros(1, 4, 8, 8), "v": torch.zeros(1, 4, 8, 8)}
    g = torch.Generator()
    return {
        "sequence_axis": lambda: tdec.init_decoder(
            g, dataclasses.replace(cfg, sequence_axis="seq")),
        "kv_window": lambda: tdec.init_cache(
            dataclasses.replace(cfg, kv_window=16), 1, 8),
        "kv_cache_int8": lambda: tdec.init_cache(
            dataclasses.replace(cfg, kv_cache_dtype="int8"), 1, 8),
        "shared_kv": lambda: tattn.self_attention(
            small, x, heads=4, cache=cache, cache_index=0, shared_kv=cache),
        "moe": lambda: tdec.init_decoder(
            g, dataclasses.replace(cfg, moe_experts=4)),
        "w8": lambda: ParamTree(from_jax_params(
            {"w": {"q": np.zeros((2, 2), np.int8),
                   "scale": np.ones((1, 2), np.float32)}})).set_trainable(),
        "lora": lambda: from_jax_params(
            {"w": np.zeros((2, 2)), "lora": {"a": np.zeros((2, 1))}}),
        "dropout": lambda: tattn.self_attention(
            small, x, heads=4, attn_dropout=0.1, rng=g),
        "optimizer_8bit": lambda: Trainer(None, None,
                                          TrainConfig(optimizer="lion8bit")),
        "grad_accum": lambda: Trainer(None, None, TrainConfig(grad_accum=2)),
        "mesh": lambda: Trainer(None, None, TrainConfig(fsdp=2)),
        "per_process_batches": lambda: Trainer(
            None, None, TrainConfig(per_process_batches=True)),
        "remat_dots_no_batch": lambda: tdec.init_decoder(
            g, dataclasses.replace(cfg, remat=True,
                                   remat_policy="dots_no_batch")),
        "orbax_checkpoint": lambda: tckpt.restore_checkpoint(
            str(_orbax_dir(tmp_path)), {}),
    }


def _orbax_dir(tmp_path):
    path = tmp_path / "step_1"
    path.mkdir(exist_ok=True)
    (path / "_CHECKPOINT_METADATA").write_text("{}")
    return path


FEATURES = ("sequence_axis", "kv_window", "kv_cache_int8", "shared_kv", "moe",
            "w8", "lora", "dropout", "optimizer_8bit", "grad_accum", "mesh",
            "per_process_batches", "remat_dots_no_batch", "orbax_checkpoint")


@pytest.mark.parametrize("feature", FEATURES)
def test_out_of_slice_features_raise(feature, tmp_path):
    calls = _feature_calls(tmp_path)
    assert sorted(calls) == sorted(FEATURES)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        calls[feature]()
