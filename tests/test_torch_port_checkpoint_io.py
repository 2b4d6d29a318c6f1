"""kosmosx_torch's checkpoint I/O against kosmosx_tpu's, on the CPU.

No pretrained weights can be downloaded, so every artifact is made here:
reference-format state dicts from JAX's exporter over a seeded Kosmos, an
HF ``CLIPVisionModel`` from a tiny config, and orbax checkpoints written by
the JAX package (params-only in fp32, bf16, W8 codes and ``scan_layers``
stacks, and a ``Trainer`` state). The port's importers must give tensors
identical to ``from_jax_params`` of JAX's own import, its exporter JAX's
keys and values, and its orbax reader (tensorstore only, in a process that
never imports ``jax``) JAX's leaves.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.core.params import ParamTree
from kosmosx_torch.models.kosmos import Kosmos as TKosmos
from kosmosx_torch.scripts import import_reference as timport
from kosmosx_torch.scripts import train as ttrain_cli
from kosmosx_torch.train import checkpoint as tckpt
from kosmosx_torch.utils import hf_convert as thf
from kosmosx_torch.utils import ref_checkpoint as tref
from kosmosx_torch.utils.jax_params import from_jax_params
from kosmosx_tpu.models.kosmos import Kosmos as JKosmos
from kosmosx_tpu.nn import decoder as jdec
from kosmosx_tpu.train import checkpoint as jckpt
from kosmosx_tpu.utils import hf_convert as jhf
from kosmosx_tpu.utils import quantize as jquant
from kosmosx_tpu.utils import ref_checkpoint as jref

ROOT = Path(__file__).resolve().parents[1]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named(tree):
    """name -> tensor of a port parameter tree."""
    return {n: p.detach() for n, p in ParamTree(tree).named_parameters()}


def assert_same_tensors(got, want):
    got, want = _named(got), _named(want)
    assert sorted(got) == sorted(want)
    for n, t in want.items():
        assert got[n].dtype == t.dtype and got[n].shape == t.shape, n
        assert torch.equal(got[n], t), n


def kcfg(mod, multiway=True):
    """scripts/import_reference.py's tiny-test config."""
    return mod.KosmosConfig(
        decoder=mod.MagnetoConfig(vocab_size=64, embed_dim=32, ffn_dim=64,
                                  layers=2, heads=4, max_positions=64,
                                  use_flash_attention=False, multiway=multiway,
                                  dropout=0.0, attention_dropout=0.0),
        vision=mod.VisionConfig(image_size=28, patch_size=14, hidden_dim=32,
                                layers=2, heads=2, mlp_dim=64,
                                use_flash_attention=False),
        resampler=mod.ResamplerConfig(dim=32, depth=2, dim_head=8, heads=2,
                                      num_latents=4, num_media_embeds=5),
        image_embed_len=4)


@pytest.fixture(scope="module", params=[True, False], ids=["multiway", "plain"])
def ref_pair(request):
    """A seeded JAX Kosmos, its reference state dict (torch tensors, with
    the decoder's aliases) and JAX's import of it."""
    cfg = kcfg(jcfg, request.param)
    params = JKosmos.init(jax.random.PRNGKey(0), cfg)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          jref.state_dict_from_kosmos_params(params).items()}
    return request.param, params, sd, jref.kosmos_params_from_state_dict(sd, cfg)


# ---------------------------------------------------------------------------
# the reference's state dicts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["state_dict", "aliases_only_wrapped",
                                  "pt_file"])
def test_reference_import_matches_jax(ref_pair, form, tmp_path):
    """The port's importer gives ``from_jax_params`` of JAX's import bit
    for bit: from the state dict, from one holding only the decoder's
    aliases of the embeddings and output projection under DDP's
    ``module.`` prefix inside ``{"model": ...}``, and from a torch file."""
    multiway, _, sd, want = ref_pair
    cfg = kcfg(tcfg, multiway)
    if form == "state_dict":
        got = tref.kosmos_params_from_state_dict(sd, cfg)
    else:
        if form == "aliases_only_wrapped":
            sd = {k: v for k, v in sd.items() if k not in (
                "embed.weight", "embed_positions.weight",
                "output_projection.weight")}
            sd = {"model": {f"module.{k}": v for k, v in sd.items()}}
        path = tmp_path / "final_model.pt"
        torch.save(sd, path)
        got = tref.load_reference_checkpoint(str(path), cfg)
    assert_same_tensors(got, from_jax_params(_np_tree(want)))
    model = TKosmos(cfg, params=got)
    assert next(model.parameters()).is_contiguous()


def test_reference_import_refuses_a_depth_mismatch(ref_pair):
    multiway, _, sd, _ = ref_pair
    cfg = kcfg(tcfg, multiway)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                               layers=3))
    with pytest.raises(ValueError, match="2 decoder layers"):
        tref.kosmos_params_from_state_dict(sd, cfg)


def test_reference_export_matches_jax(ref_pair):
    """Keys (the aliases included) and values of JAX's export; the port's
    import of its own export is the model again."""
    multiway, params, _, _ = ref_pair
    model = TKosmos(kcfg(tcfg, multiway), params=from_jax_params(
        _np_tree(params)))
    got = tref.state_dict_from_kosmos_params(model)
    want = jref.state_dict_from_kosmos_params(params)
    assert sorted(got) == sorted(want)
    assert "decoder.embed_tokens.weight" in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    back = tref.kosmos_params_from_state_dict(got, model.config)
    assert_same_tensors(back, from_jax_params(_np_tree(params)))


# ---------------------------------------------------------------------------
# HF CLIP
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_clip():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, image_size=56, patch_size=14,
        hidden_act="gelu", layer_norm_eps=1e-5)
    torch.manual_seed(0)
    return transformers.CLIPVisionModel(hf_cfg).eval()


def test_clip_converter_matches_jax_and_hf(hf_clip):
    """The converted tree is JAX's converter's, and the port's ViT on it
    gives HF's last_hidden_state."""
    from kosmosx_torch.nn.vision import clip_vit

    got = thf.clip_vision_params_from_hf(hf_clip)
    assert_same_tensors(got, from_jax_params(
        jhf.clip_vision_params_from_hf(hf_clip)))
    assert_same_tensors(thf.clip_vision_params_from_hf(hf_clip.state_dict()),
                        got)
    pix = torch.randn(2, 3, 56, 56, generator=torch.Generator().manual_seed(1))
    vcfg = tcfg.VisionConfig(image_size=56, patch_size=14, hidden_dim=64,
                             layers=2, heads=4, mlp_dim=128,
                             use_flash_attention=False)
    with torch.no_grad():
        ref = hf_clip(pixel_values=pix).last_hidden_state
        ours = clip_vit(ParamTree(got), pix, vcfg)
    torch.testing.assert_close(ours, ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("form", ["safetensors", "bin", "dir"])
def test_load_clip_checkpoint(hf_clip, form, tmp_path):
    """A local HF file: model.safetensors, a torch pytorch_model.bin (a
    full CLIPModel's, with text_model keys), or the directory holding it."""
    sd = {f"vision_model.{k}": v.clone() for k, v in
          hf_clip.vision_model.state_dict().items()}
    if form == "safetensors":
        safetensors = pytest.importorskip("safetensors.torch")
        path = tmp_path / "model.safetensors"
        safetensors.save_file(sd, str(path))
    else:
        sd["text_model.embeddings.token_embedding.weight"] = torch.zeros(4, 8)
        path = tmp_path / "pytorch_model.bin"
        torch.save(sd, path)
    got = thf.load_clip_checkpoint(str(tmp_path if form == "dir" else path))
    assert_same_tensors(got, thf.clip_vision_params_from_hf(hf_clip))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        thf.load_clip_checkpoint(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# the JAX package's orbax checkpoints
# ---------------------------------------------------------------------------

DEC_KW = dict(vocab_size=97, embed_dim=32, ffn_dim=64, layers=2, heads=4,
              max_positions=64, multiway=True, dropout=0.0,
              attention_dropout=0.0)


def _orbax_cases(root: Path) -> dict:
    """name -> (orbax directory, the JAX tree it holds)."""
    params = jdec.init_decoder(jax.random.PRNGKey(0), jcfg.MagnetoConfig(**DEC_KW))
    stacked = jdec.init_decoder(jax.random.PRNGKey(1), jcfg.MagnetoConfig(
        **DEC_KW, scan_layers=True))
    trees = {
        "fp32": params,
        "bf16": jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                       params),
        "w8": jquant.quantize_params_w8(params, min_size=1024),
        "w8_stacked": jquant.quantize_params_w8(stacked, min_size=1024),
    }
    cases = {name: (jckpt.save_params(tree, str(root / name)), tree)
             for name, tree in trees.items()}
    state = {"params": params, "opt_state": optax.adamw(1e-3).init(params),
             "step": jnp.int32(3), "rng": jax.random.PRNGKey(2)}
    cases["trainer"] = (jckpt.save_checkpoint(state, str(root / "run"), 3),
                        params)
    return cases


READER = """
import sys, torch
from kosmosx_torch.train import checkpoint as ck
out = {name: ck.restore_params(path) for name, path in CASES.items()}
bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.',
       'kosmosx_tpu', 'orbax'))]
assert not bad, bad
torch.save(out, OUT)
"""


@pytest.fixture(scope="module")
def orbax_read(tmp_path_factory):
    """Every case read by the port in a fresh process that must never
    import jax, orbax or kosmosx_tpu."""
    root = tmp_path_factory.mktemp("orbax")
    cases = _orbax_cases(root)
    out = root / "read.pt"
    code = (f"CASES = {({k: v[0] for k, v in cases.items()})!r}\n"
            f"OUT = {str(out)!r}\n" + READER)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT),
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return cases, torch.load(out, weights_only=True)


@pytest.mark.parametrize("case", ["fp32", "bf16", "w8", "w8_stacked",
                                  "trainer"])
def test_orbax_checkpoint_reads_as_from_jax_params(orbax_read, case):
    cases, read = orbax_read
    want = _named(from_jax_params(_np_tree(cases[case][1])))
    got = read[case]
    assert sorted(got) == sorted(want)
    for n, t in want.items():
        assert got[n].dtype == t.dtype and torch.equal(got[n], t), n
    if case.startswith("w8"):
        assert any(t.dtype == torch.int8 for t in got.values())
    if case == "w8_stacked":  # each layer stack is held once, (L, K, N)
        stacks = [t for t in got.values() if t.dtype == torch.int8
                  and t.ndim == 3]
        assert stacks and all(t.shape[0] == 2 for t in stacks)


def test_orbax_checkpoint_loads_into_a_model(orbax_read):
    """``read_orbax_params`` builds a model whose logits are those of the
    JAX tree carried across, W8 stacked layout included; the training CLI's
    restore into a seeded model matches too."""
    from kosmosx_torch.models.language import KosmosLanguage

    cases, _ = orbax_read
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        4, 97, (2, 12))).long()
    for case, scan in (("fp32", False), ("w8_stacked", True)):
        cfg = tcfg.MagnetoConfig(**DEC_KW, scan_layers=scan)
        path, tree = cases[case]
        got = KosmosLanguage(cfg, params=tckpt.read_orbax_params(path))
        want = KosmosLanguage(cfg, params=from_jax_params(_np_tree(tree)))
        assert torch.equal(got.apply(toks), want.apply(toks)), case
    seeded = KosmosLanguage(tcfg.MagnetoConfig(**DEC_KW),
                            generator=torch.Generator().manual_seed(5),
                            device="cpu")
    tckpt.restore_params(cases["fp32"][0], seeded)
    assert torch.equal(seeded.apply(toks), KosmosLanguage(
        tcfg.MagnetoConfig(**DEC_KW), params=from_jax_params(
            _np_tree(cases["fp32"][1]))).apply(toks))


def test_orbax_reader_names_tensorstore_when_missing(monkeypatch, tmp_path):
    import builtins

    real_import = builtins.__import__

    def no_tensorstore(name, *args, **kw):
        if name == "tensorstore":
            raise ImportError("No module named 'tensorstore'")
        return real_import(name, *args, **kw)

    (tmp_path / "_METADATA").write_text('{"tree_metadata": {}}')
    monkeypatch.setattr(builtins, "__import__", no_tensorstore)
    with pytest.raises(ImportError, match="tensorstore"):
        tckpt.restore_params(str(tmp_path))


@pytest.mark.parametrize("layout", [{"use_zarr3": True},
                                    {"use_ocdbt": False}],
                         ids=["zarr3", "no_ocdbt"])
def test_orbax_reader_refuses_other_layouts(layout, tmp_path):
    """The JAX package writes zarr leaves over ocdbt; any other layout is
    refused by name, never read by a second path."""
    import json

    (tmp_path / "_METADATA").write_text(json.dumps(
        {"tree_metadata": {}, **layout}))
    with pytest.raises(ValueError, match="zarr over ocdbt"):
        tckpt.read_orbax_tree(str(tmp_path))


# ---------------------------------------------------------------------------
# the import CLI, then training from its output
# ---------------------------------------------------------------------------

TINY_KOSMOS = ["--model", "kosmos", "--vocab-size", "64", "--dim", "32",
               "--ffn-dim", "64", "--layers", "2", "--heads", "4",
               "--max-positions", "64", "--image-size", "28",
               "--patch-size", "14", "--vision-dim", "32",
               "--vision-layers", "2", "--vision-heads", "2",
               "--vision-mlp-dim", "64", "--resampler-depth", "2",
               "--latents", "4", "--device", "cpu"]


@pytest.mark.parametrize("depth", [2, 1], ids=["tiny", "depth_cut"])
def test_import_reference_then_train_init_checkpoint(depth, tmp_path, capsys):
    """``import_reference --final-model`` on a reference file written by
    JAX's exporter, then the training CLI warm-started from its output: the
    written parameters are the file's, and training runs from them. A
    depth-cut file imports at the decoder and ViT depths its keys hold. The
    resampler has the shape the training CLI builds (ResamplerConfig's
    heads and head width), as the port's tiny-test config has."""
    cfg = kcfg(jcfg)
    cfg = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, layers=depth),
        vision=dataclasses.replace(cfg.vision, layers=depth),
        resampler=jcfg.ResamplerConfig(dim=32, depth=2, num_latents=4,
                                       num_media_embeds=5))
    params = JKosmos.init(jax.random.PRNGKey(3), cfg)
    ref_file = tmp_path / "final_model.pt"
    jref.save_reference_checkpoint(params, str(ref_file))
    out = tmp_path / "imported"
    assert timport.main(["--final-model", str(ref_file), "--out", str(out),
                         "--config", "tiny-test"]) == 0
    written = tckpt.restore_params(str(out))
    want = _named(from_jax_params(_np_tree(params)))
    assert sorted(written) == sorted(want)
    assert all(torch.equal(written[n], t) for n, t in want.items())
    cli = list(TINY_KOSMOS)
    for flag in ("--layers", "--vision-layers"):
        cli[cli.index(flag) + 1] = str(depth)
    assert ttrain_cli.main(cli + [
        "--synthetic", "--seq-len", "16", "--steps", "2", "--batch-size", "2",
        "--init-checkpoint", str(out), "--output-dir", str(tmp_path / "run"),
        "--no-final-save"]) == 0
    assert "final:" in capsys.readouterr().out


def test_import_reference_clip_graft(tmp_path):
    """``--clip`` grafts the converted tower into the seeded init: the
    written CLIP tensors are the converter's, the rest the init's."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(1)
    hf = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, image_size=28, patch_size=14,
        hidden_act="gelu", layer_norm_eps=1e-5))
    torch.save(hf.state_dict(), tmp_path / "pytorch_model.bin")
    out = tmp_path / "grafted"
    assert timport.main(["--clip", str(tmp_path), "--out", str(out),
                         "--config", "tiny-test", "--device", "cpu",
                         "--seed", "4"]) == 0
    written = tckpt.restore_params(str(out))
    clip = {f"clip.{n}": t for n, t in
            _named(thf.clip_vision_params_from_hf(hf)).items()}
    init = TKosmos(timport.model_config("tiny-test"),
                   generator=torch.Generator().manual_seed(4), device="cpu")
    want = {n: clip.get(n, p.detach()) for n, p in init.named_parameters()}
    assert sorted(written) == sorted(want)
    assert all(torch.equal(written[n], t) for n, t in want.items())


@pytest.mark.parametrize("kind", ["port", "orbax"])
def test_generate_cli_loads_a_params_directory(kind, tmp_path, monkeypatch):
    """The generation CLI's ``--checkpoint`` takes a params directory (the
    port's ``save_params``, or a params-only orbax checkpoint of the JAX
    package): its weights decide the tokens."""
    import contextlib
    import io

    from kosmosx_torch.data.tokenizer import KosmosTokenizer
    from kosmosx_torch.generate.sampler import SamplingConfig, generate_text
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.scripts import generate as tgen

    monkeypatch.setitem(sys.modules, "transformers", None)  # byte tokenizer
    kw = dict(vocab_size=300, embed_dim=32, ffn_dim=64, layers=2, heads=4,
              dropout=0.0, attention_dropout=0.0)
    jparams = jdec.init_decoder(jax.random.PRNGKey(6), jcfg.MagnetoConfig(**kw))
    cfg = tcfg.MagnetoConfig(**kw)
    model = KosmosLanguage(cfg, params=from_jax_params(_np_tree(jparams)))
    path = tmp_path / "params"
    if kind == "port":
        tckpt.save_params(model, str(path))
    else:
        jckpt.save_params(jparams, str(path))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tgen.main(["--device", "cpu", "--layers", "2", "--dim", "32",
                          "--ffn-dim", "64", "--heads", "4", "--vocab-size",
                          "300", "--max-new-tokens", "4", "--dtype",
                          "float32", "--prompt", "hi", "--greedy",
                          "--checkpoint", str(path)]) == 0
    out = out.getvalue()
    assert f"loaded {path}" in out
    prompt, _ = KosmosTokenizer(use_hf=False).tokenize_texts("hi",
                                                            modalities=())
    want = generate_text(model, cfg, torch.from_numpy(prompt).long(),
                         SamplingConfig(max_new_tokens=4, greedy=True))
    assert eval(out.split("generated ids:")[1].splitlines()[0]) == \
        want[0].tolist()


@pytest.mark.skipif(not os.environ.get("KOSMOSX_REF_WEIGHTS"),
                    reason="KOSMOSX_REF_WEIGHTS not set")
def test_real_reference_checkpoint_imports():
    """A real final_model.pt -> the flagship tree -> finite logits."""
    cfg = tcfg.KosmosConfig()
    model = TKosmos(cfg, params=tref.load_reference_checkpoint(
        os.environ["KOSMOSX_REF_WEIGHTS"], cfg))
    logits = model.apply(torch.tensor([[0, 4, 10, 11, 12, 13]]),
                         torch.zeros(1, 3, 224, 224))
    assert torch.isfinite(logits).all()


@pytest.mark.skipif(not os.environ.get("KOSMOSX_CLIP_WEIGHTS"),
                    reason="KOSMOSX_CLIP_WEIGHTS not set")
def test_real_clip_checkpoint_imports():
    from kosmosx_torch.nn.vision import clip_vit

    p = ParamTree(thf.load_clip_checkpoint(os.environ["KOSMOSX_CLIP_WEIGHTS"]))
    feats = clip_vit(p, torch.zeros(1, 3, 224, 224), tcfg.VisionConfig())
    assert feats.shape == (1, 257, 1024) and torch.isfinite(feats).all()
