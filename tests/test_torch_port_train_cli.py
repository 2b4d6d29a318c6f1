"""kosmosx_torch's evaluation and its training and eval CLIs on the CPU.

``evaluate_perplexity`` against kosmosx_tpu's on the same fp32 parameters
(bar 1e-5 relative: both reduce the NLL in fp32); BLEU, ROUGE-L, token F1
and exact match equal to JAX's on random token lists. The CLIs: the port's
parsers hold every option string of JAX's with its default, plus
``--device``; tiny ``--device cpu`` runs of each data source, the 8-bit
optimizers with accumulation, ``--init-checkpoint``, ``--eval-every``, and
the eval CLI on the run's checkpoint; the raises of what is not ported;
and one ``--resume`` in a fresh process, whose losses equal an
uninterrupted run's.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import kosmosx_torch.core.config as tcfg
import kosmosx_tpu.core.config as jcfg
from kosmosx_torch.eval import perplexity as tppl
from kosmosx_torch.eval import text_metrics as ttm
from kosmosx_torch.models.language import KosmosLanguage as TLanguage
from kosmosx_torch.scripts import eval as teval_cli
from kosmosx_torch.scripts import train as ttrain_cli
from kosmosx_torch.utils.jax_params import from_jax_params
from kosmosx_tpu.eval import perplexity as jppl
from kosmosx_tpu.eval import text_metrics as jtm
from kosmosx_tpu.nn import decoder as jdec
from test_torch_port_model import dec_cfg

ROOT = Path(__file__).resolve().parents[1]
WORDS = "the a cat dog sat on mat ran far and jumped over fence".split()
TINY = ["--layers", "2", "--dim", "32", "--ffn-dim", "64", "--heads", "4",
        "--device", "cpu"]
TINY_VISION = ["--image-size", "28", "--patch-size", "14", "--vision-dim",
               "32", "--vision-layers", "1", "--vision-heads", "4",
               "--vision-mlp-dim", "64", "--resampler-depth", "1",
               "--latents", "8"]


def _jax_parser(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_cli_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_parser()


def _options(parser):
    return {s: a.default for a in parser._actions for s in a.option_strings
            if s not in ("-h", "--help")}


@pytest.mark.parametrize("name,port,own", [
    ("train", ttrain_cli, {"--device", "--trace-out"}),
    ("eval", teval_cli, {"--device"})])
def test_parsers_hold_every_jax_option(name, port, own):
    """The port's CLIs take every JAX option at its default, and add only
    their own: ``--device`` (and the training CLI's ``--trace-out``)."""
    jax_opts = _options(_jax_parser(name))
    port_opts = _options(port.build_parser())
    assert set(port_opts) - set(jax_opts) == own
    assert set(jax_opts) <= set(port_opts)
    for opt, default in jax_opts.items():
        assert port_opts[opt] == default, opt
    assert port_opts["--device"] == "cuda"


def test_evaluate_perplexity_matches_jax():
    cfg_j, cfg_t = dec_cfg(jcfg), dec_cfg(tcfg)
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init_decoder(jax.random.PRNGKey(2), cfg_j))
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        ids = rng.integers(4, 97, (2, 40)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[1, 30:] = 0
        batches.append({"input_ids": ids, "attention_mask": mask})
    with jax.default_matmul_precision("highest"):
        want = jppl.evaluate_perplexity(params, batches, cfg_j, max_batches=2)
    model = TLanguage(cfg_t, params=from_jax_params(params))
    got = tppl.evaluate_perplexity(model, batches, cfg_t, max_batches=2)
    assert got["batches"] == want["batches"] == 2
    assert got["tokens"] == want["tokens"]
    for key in ("perplexity", "cross_entropy"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_text_metrics_match_jax():
    rng = np.random.default_rng(4)

    def toks():
        return [str(t) for t in rng.integers(0, 6, rng.integers(0, 12))]

    cands = [toks() for _ in range(40)]
    refs = [toks() for _ in range(40)]
    cands[0] = refs[0] = []
    cands[1] = list(refs[1])
    assert ttm.bleu(cands, refs) == jtm.bleu(cands, refs)
    assert ttm.bleu(cands[2:], refs[2:], max_n=2) == \
        jtm.bleu(cands[2:], refs[2:], max_n=2)
    assert ttm.bleu(["a b c"], ["a b c"]) == jtm.bleu(["a b c"], ["a b c"])
    for c, r in zip(cands, refs):
        for fn in ("rouge_l", "token_f1", "exact_match"):
            assert getattr(ttm, fn)(c, r) == getattr(jtm, fn)(c, r), fn
    assert ttm.exact_match("a b", ["a", "b"]) == 1.0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "docs.txt"
    rng = np.random.default_rng(5)
    path.write_text("\n".join(" ".join(rng.choice(WORDS, rng.integers(3, 30)))
                              for _ in range(120)) + "\n")
    return str(path)


def _records(path):
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()]


def test_train_cli_text_files_8bit_accum_and_eval(tmp_path, corpus, capsys):
    out = tmp_path / "run"
    argv = TINY + ["--text-files", corpus, "--seq-len", "64",
                   "--batch-size", "2", "--remat", "--remat-policy",
                   "dots_no_batch", "--optimizer", "lion8bit",
                   "--grad-accum", "2", "--steps", "4",
                   "--checkpoint-every", "4", "--log-every", "1",
                   "--metrics-jsonl", str(tmp_path / "m.jsonl"),
                   "--output-dir", str(out)]
    assert ttrain_cli.main(argv) == 0
    recs = _records(tmp_path / "m.jsonl")
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in recs)
    assert (out / "step_4" / "state.pt").exists()
    assert (out / "final" / "params.pt").exists()
    capsys.readouterr()
    assert teval_cli.main(TINY + ["--checkpoint", str(out), "--data", corpus,
                                  "--seq-len", "64", "--max-batches", "2",
                                  "--dtype", "float32"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["batches"] == 2 and result["tokens"] == 2 * 4 * 63
    assert np.isfinite(result["perplexity"])
    # the final params warm-start another run, evaluated every 2 steps
    tokens = np.random.default_rng(6).integers(4, 97, 3000).astype(np.uint16)
    np.save(tmp_path / "held.npy", tokens)
    assert ttrain_cli.main(TINY + [
        "--pretokenized", str(tmp_path / "held.npy"), "--seq-len", "32",
        "--steps", "2", "--optimizer", "adamw8bit", "--init-checkpoint",
        str(out / "final"), "--eval-every", "2", "--eval-pretokenized",
        str(tmp_path / "held.npy"), "--eval-batches", "2", "--log-every", "1",
        "--metrics-jsonl", str(tmp_path / "w.jsonl"), "--no-final-save",
        "--output-dir", str(tmp_path / "warm")]) == 0
    recs = _records(tmp_path / "w.jsonl")
    assert "eval_loss" in recs[1] and not (tmp_path / "warm" / "final").exists()


@pytest.mark.parametrize("source", ["synthetic", "dataset_dir"])
def test_train_cli_kosmos(tmp_path, source):
    if source == "synthetic":
        data = ["--synthetic"]
    else:
        rng = np.random.default_rng(7)
        recs = []
        for i in range(4):
            np.save(tmp_path / f"{i}.npy",
                    rng.integers(0, 256, (3, 28, 28)).astype(np.uint8))
            recs.append({"image": f"{i}.npy",
                         "text": " ".join(rng.choice(WORDS, 12))})
        (tmp_path / "captions.jsonl").write_text(
            "\n".join(json.dumps(r) for r in recs))
        data = ["--dataset-dir", str(tmp_path)]
    argv = TINY + TINY_VISION + data + [
        "--model", "kosmos", "--seq-len", "24", "--batch-size", "2",
        "--freeze-vision", "--optimizer", "adamw8bit", "--grad-accum", "2",
        "--steps", "4", "--log-every", "1", "--checkpoint-every", "0",
        "--metrics-jsonl", str(tmp_path / "m.jsonl"), "--no-final-save",
        "--output-dir", str(tmp_path / "out"), "--vocab-size", "300"]
    assert ttrain_cli.main(argv) == 0
    assert len(_records(tmp_path / "m.jsonl")) == 4


def test_train_cli_resumes_in_a_fresh_process(tmp_path, corpus):
    """4 micro-steps (accumulation 2, dropout on) in this process; then 2,
    and ``--resume`` for 2 more in a new one: steps 3-4 log the same
    losses."""
    common = TINY + ["--text-files", corpus, "--seq-len", "48",
                     "--batch-size", "2", "--grad-accum", "2",
                     "--optimizer", "adamw8bit", "--schedule", "constant",
                     "--warmup-steps", "1", "--lr", "1e-2",
                     "--checkpoint-every", "2", "--log-every", "1",
                     "--no-final-save"]

    def run(name, steps, *extra):
        return common + ["--steps", str(steps), "--output-dir",
                         str(tmp_path / name), "--metrics-jsonl",
                         str(tmp_path / f"{name}.jsonl"), *extra]

    assert ttrain_cli.main(run("whole", 4)) == 0
    assert ttrain_cli.main(run("split", 2)) == 0
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "kosmosx_torch.scripts.train",
         *run("split", 2, "--resume")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    whole = {r["step"]: r["loss"] for r in _records(tmp_path / "whole.jsonl")}
    split = {r["step"]: r["loss"] for r in _records(tmp_path / "split.jsonl")}
    assert sorted(split) == [1, 2, 3, 4]
    assert split == whole
