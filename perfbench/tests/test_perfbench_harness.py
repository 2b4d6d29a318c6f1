"""The runner: discovery of every part by name (one added as new files
too), the result line's keys, and the runs that must print no result."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests import perfbench_tiny as tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("kind", ["train", "score", "serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(kind, trace):
    line = tiny.run(kind, trace=trace)
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "compared"
    assert set(keys) == set(KEYS) | {"compared"} | (
        {"breakdown"} if trace else set())
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert ("busy_s" in dev and "window_s" in dev) == trace
    cell = tiny.cell(kind)
    names = {m["name"] for m in harness.metrics_of(cell, trace)}
    assert set(line["metrics"]) <= names
    if not trace:   # the end-to-end metrics come from the host clock
        assert set(line["metrics"]) == names
        assert "setup_s" in names and len(names) >= 2
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for k, v in line["compared"].items():
        assert v["limit"] == cell.limits[k]
    json.dumps(line)


def test_every_cell_reports_its_metrics():
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(tiny.ROOT, w["name"])
        e2e = harness.metrics_of(cell, False)
        layer = harness.metrics_of(cell, True)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer and {m["moves"] for m in layer} <= {m["name"] for m in e2e}
        harness.load_module(tiny.ROOT, "drivers", cell.traffic["driver"])
        for m in layer:
            harness.load_module(tiny.ROOT, "layer_metrics",
                                m["name"].split(".", 1)[0])
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_a_cell_added_as_files(tmp_path):
    """A configuration, a mix, a metric reader and limits added as new
    files, with entries in BENCHMARK.json, run with no edit elsewhere."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    (root / "perfbench/configs/tiny.json").write_text(
        json.dumps(dict(tiny.CONFIG, weights="bfloat16")))
    (root / "perfbench/traffic/tiny-chat.json").write_text(
        json.dumps(dict(tiny.TRAFFIC["serve"], clients=2)))
    (root / "perfbench/limits/tiny.tiny-chat.json").write_text(
        json.dumps({"control": "fp8", "limits": {"mean_token_gap": 0.5}}))
    (root / "perfbench/layer_metrics/steps_seen.py").write_text(
        "def read(r):\n    return None if r is None else float(r.steps)\n")
    bench["configs"].append({"name": "tiny", "source": "https://example.org",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.tiny-chat", "config": "tiny",
                               "traffic": "tiny-chat", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_tokens_per_s":
            m["workloads"].append("tiny.tiny-chat")
    bench["per_layer"].append({"name": "steps_seen.serve", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "serve/ (ServeEngine.step)",
                               "moves": "serve_tokens_per_s",
                               "workloads": ["tiny.tiny-chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell(root, "tiny.tiny-chat")
    assert cell.traffic["clients"] == 2 and cell.config["name"] == "tiny"
    import time

    import torch

    ctx = harness.Context(cell, 11, 0.3, True, torch.device("cpu"),
                          time.perf_counter())
    line = harness.run_cell(cell, ctx)
    assert line["correct"] is True
    assert line["metrics"]["steps_seen.serve"]["value"] > 0
    ctx = harness.Context(cell, 11, 0.3, False, torch.device("cpu"),
                          time.perf_counter())
    line = harness.run_cell(cell, ctx)
    assert set(line["metrics"]) == {"serve_tokens_per_s", "setup_s"}


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "kosmosx.train-mm-b4", "--seed", str(2 ** 32 + 3), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(tiny.ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(tiny.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    assert "kosmosx_torch is not in" in p.stderr


def test_percentile():
    assert harness.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert harness.percentile(range(101), 95) == 95.0
    assert harness.percentile([1.0, float("inf")], 95) == float("inf")


def test_profile_arithmetic():
    from perfbench.trace import Profile

    opt = frozenset({"Optimizer.step"})
    p = Profile([(0, 10, "elementwise_kernel", frozenset()),
                 (5, 20, "nvjet_gemm", opt),
                 (30, 40, "vectorized_elementwise_kernel", opt)],
                {}, [(25, 35, "Optimizer.step")], 1.0)
    assert p.busy_s() == pytest.approx(30e-6)   # a union, not a sum
    assert p.group_s(("elementwise_copy",)) == pytest.approx(20e-6)
    assert p.group_s(("elementwise_copy",), outside="Optimizer.step") == \
        pytest.approx(10e-6)
    assert p.idle_gaps() == [["host", pytest.approx(10e-6)]]
    assert p.top_ops()[0][0] == "nvjet_gemm"
