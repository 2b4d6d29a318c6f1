"""Each cell, run as the driver runs it, on the card: a short window,
``correct`` true, the result line whole, and every share of a roofline or
of the peak at most 100%. Skips without a card.

    python -m pytest -m cuda perfbench/tests/test_perfbench_cuda.py -q
"""

import json
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.perfbench_tiny import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 99), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["compared"]
    cell = harness.load_cell(ROOT, name)
    assert set(line["metrics"]) == {m["name"] for m in
                                    harness.metrics_of(cell, bool(trace))}
    for key, m in line["metrics"].items():
        if key.split(".")[0].endswith("roofline") or "mfu" in key:
            assert 0 < m["value"] <= 100, (key, m)
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
