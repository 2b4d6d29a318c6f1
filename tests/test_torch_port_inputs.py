"""kosmosx_torch's input side and generation CLI against the JAX package:
``preprocess_images`` on uint8 and float images of non-square sizes (bar
1e-4), the byte tokenizer's ids and masks (identical), and the CLI's flags
and defaults against ``scripts/generate.py``'s ``build_parser()``, with a
tiny run of each model on the CPU.
"""

import contextlib
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kosmosx_torch.data import images as timages
from kosmosx_torch.data import tokenizer as ttok
from kosmosx_torch.scripts import generate as tcli
from kosmosx_tpu.data import images as jimages
from kosmosx_tpu.data import tokenizer as jtok
from scripts import generate as jcli


@pytest.mark.parametrize("shape,kind,size", [
    ((2, 3, 300, 400), "uint8", 224), ((1, 3, 160, 120), "float", 224),
    ((1, 3, 97, 130), "float", 224), ((2, 3, 480, 640), "uint8", 224),
    ((1, 3, 224, 224), "uint8", 224), ((1, 3, 50, 31), "float", 28)])
def test_preprocess_images_matches_jax(shape, kind, size):
    rng = np.random.default_rng(sum(shape))
    if kind == "uint8":
        img = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        img = rng.random(shape).astype(np.float32)
    ref = jimages.preprocess_images(jnp.asarray(img), image_size=size)
    got = timages.preprocess_images(torch.from_numpy(img), image_size=size)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


TEXTS = ["A photo of", "", "héllo wörld ✓", "x" * 40]


@pytest.mark.parametrize("modalities", [("image",), ("image", "audio", "video"),
                                        ()])
def test_tokenizer_matches_jax(modalities):
    """Spliced and raw ids, the sample's attention mask and labels, ids
    truncated at max_length, and decode, against the JAX byte backend."""
    jt = jtok.KosmosTokenizer(use_hf=False, modalities=modalities,
                              image_embed_len=8)
    tt = ttok.KosmosTokenizer(use_hf=False, modalities=modalities,
                              image_embed_len=8)
    assert (tt.vocab_size, tt.im_idx, tt.im_end_idx) == \
        (jt.vocab_size, jt.im_idx, jt.im_end_idx)
    for max_length in (None, 6):
        for got, ref in zip(tt.tokenize_texts(TEXTS, max_length),
                            jt.tokenize_texts(TEXTS, max_length)):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, ref)
    ids, _ = tt.tokenize_texts(TEXTS)
    for row in ids:
        assert tt.decode(row) == jt.decode(row)
        assert tt.decode(torch.from_numpy(row)) == jt.decode(row)
    if modalities == ("image",):
        img = np.random.default_rng(0).integers(0, 256, (4, 3, 40, 30)) \
            .astype(np.uint8)
        sample = {"target_text": TEXTS, "image": img}
        got, ref = tt.tokenize(sample), jt.tokenize(sample)
        for key in ("text_tokens", "labels", "attention_mask"):
            np.testing.assert_array_equal(got[key], np.asarray(ref[key]))
        np.testing.assert_allclose(got["images"].numpy(),
                                   np.asarray(ref["images"]), atol=1e-4)


def test_byte_tokenizer_matches_jax():
    jb, tb = jtok.ByteTokenizer(["<x>"]), ttok.ByteTokenizer(["<x>"])
    for text in TEXTS:
        for kw in ({}, {"add_bos": False, "add_eos": True}):
            assert tb.encode(text, **kw) == jb.encode(text, **kw)
    ids = tb.encode("ab", add_eos=True) + [tb.convert_tokens_to_ids("<x>"), 3]
    assert tb.decode(ids) == jb.decode(ids) == "ab<x>"


def test_cli_flags_and_defaults_match_jax():
    """Every flag of the JAX CLI with its default; the port adds
    ``--device`` (default ``cuda``)."""
    ref = vars(jcli.build_parser().parse_args([]))
    got = vars(tcli.build_parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == ref


@pytest.fixture
def no_hf(monkeypatch):
    """The byte tokenizer, as on a machine without ``transformers``."""
    monkeypatch.setitem(sys.modules, "transformers", None)


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert tcli.main(argv) == 0
    return out.getvalue(), err.getvalue()


TINY = ["--device", "cpu", "--layers", "2", "--dim", "32", "--ffn-dim", "64",
        "--heads", "4", "--vocab-size", "300", "--max-new-tokens", "4",
        "--dtype", "float32"]


@pytest.mark.parametrize("extra", [
    ["--greedy"], ["--beam-size", "2"], ["--kv-window", "16", "--greedy"],
    ["--w8", "--greedy"], ["--temperature", "0.7", "--top-k", "5"]],
    ids=["greedy", "beam", "kv_window", "w8", "sampled"])
def test_cli_runs_language_on_cpu(extra, no_hf):
    out, err = _run(TINY + ["--prompt", "hi"] + extra)
    ids = eval(out.split("generated ids:")[1].splitlines()[0])
    assert len(ids) == 4 and all(0 <= i < 300 for i in ids)
    assert ("# best beam score" in err) == ("--beam-size" in extra)


def test_cli_runs_kosmos_on_an_image(tmp_path, no_hf):
    """``--model kosmos`` on a uint8 .npy image of a non-square size (the
    CLI's vision tower is always ViT-L/14)."""
    path = tmp_path / "img.npy"
    np.save(path, np.random.default_rng(0).integers(0, 256, (3, 300, 200))
            .astype(np.uint8))
    out, _ = _run(TINY + ["--model", "kosmos", "--image", str(path),
                          "--greedy"])
    assert len(eval(out.split("generated ids:")[1].splitlines()[0])) == 4


def test_cli_loads_a_trainer_checkpoint(tmp_path, no_hf):
    """``--checkpoint``: the latest step of a Trainer directory is loaded;
    its weights decide the tokens."""
    from kosmosx_torch.core.config import MagnetoConfig
    from kosmosx_torch.generate.sampler import SamplingConfig, generate_text
    from kosmosx_torch.models.language import KosmosLanguage
    from kosmosx_torch.train import checkpoint as ckpt

    cfg = MagnetoConfig(vocab_size=300, embed_dim=32, layers=2, ffn_dim=64,
                        heads=4, dropout=0.0, attention_dropout=0.0)
    model = KosmosLanguage(cfg, generator=torch.Generator().manual_seed(5),
                           device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    for step in (1, 3):
        ckpt.save_checkpoint({"params": model, "opt_state": opt,
                              "step": step, "rng": None},
                             str(tmp_path), step)
    argv = TINY + ["--prompt", "hi", "--greedy", "--seed", "1"]
    out, _ = _run(argv + ["--checkpoint", str(tmp_path)])
    assert f"loaded {tmp_path / 'step_3'} (step 3)" in out
    ids = eval(out.split("generated ids:")[1].splitlines()[0])
    prompt, _ = ttok.KosmosTokenizer(use_hf=False).tokenize_texts(
        "hi", modalities=())
    want = generate_text(model, cfg, torch.from_numpy(prompt).long(),
                         SamplingConfig(max_new_tokens=4, greedy=True))
    assert ids == want[0].tolist()
    with pytest.raises(SystemExit, match="no checkpoint"):
        _run(argv + ["--checkpoint", str(tmp_path / "none")])
