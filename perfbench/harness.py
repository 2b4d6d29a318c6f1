"""The benchmark's runner: finds a cell's files by name, runs its window
driver, reads its metrics and prints the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs[].file``: the configuration (sizes, dtypes, its reference);
- ``perfbench/traffic/<traffic>.json``: the mix, naming its driver;
- ``perfbench/drivers/<driver>.py``: the window driver, ``run(ctx)``;
- ``perfbench/layer_metrics/<family>.py``: the reader of the per-layer
  metrics ``<family>`` and ``<family>.<anything>``, ``read(readings)``;
- ``perfbench/limits/<workload>.json``: the limit of each number the
  cell's correctness check compares (``limits``), and the precision its
  control runs at (``control``, read by ``perfbench/controls.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "kosmosx_tpu")


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    root: Path
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    control: str = None

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_module(root: Path, kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` under ``root``, by its path."""
    path = root / "perfbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(workloads)})")
    w = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (root / "perfbench" / "limits" / f"{name}.json").read_text())
    return Cell(root, bench, w, config, traffic, limits["limits"],
                limits["control"])


def metrics_of(cell: Cell, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    metrics: those that list it, and those that list no cell and move an
    end-to-end metric it reports."""
    e2e = [m for m in cell.bench["end_to_end"]
           if cell.name in m.get("workloads", [cell.name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in cell.bench["per_layer"]
            if cell.name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moved)]


@dataclasses.dataclass
class Context:
    """What a window driver gets."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float                       # the process's start (host clock)
    faults: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Outcome:
    """What a window driver returns."""

    attempted: int
    failed: int
    e2e: Dict[str, float]
    compared: Dict[str, float]
    memory_peak_bytes: int
    readings: Any = None            # for the per-layer readers (traced run)
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between the order statistics (an
    infinite one, a request that failed, reads as infinite)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if pos == lo or xs[hi] == xs[lo]:
        return xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def judge(compared: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared is finite and within its limit, and every
    limit has its number."""
    if set(compared) != set(limits):
        return False
    return all(math.isfinite(v) and v <= limits[k]
               for k, v in compared.items())


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark must not load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def run_cell(cell: Cell, ctx: Context) -> dict:
    """Run the cell's driver and build the result line."""
    driver = load_module(cell.root, "drivers", cell.traffic["driver"])
    out: Outcome = driver.run(ctx)
    metrics = {}
    for m in metrics_of(cell, ctx.trace):
        if ctx.trace:
            family = m["name"].split(".", 1)[0]
            value = load_module(cell.root, "layer_metrics", family).read(
                out.readings)
        else:
            value = out.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind(ctx.device),
              "count": int(cell.workload["chips"]),
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line: Dict[str, Any] = {"correct": judge(out.compared, cell.limits),
                            "attempted": out.attempted, "failed": out.failed,
                            "metrics": metrics, "device": device}
    if ctx.trace and out.readings is not None:
        prof = out.readings.profile
        device["busy_s"] = prof.busy_s()
        device["window_s"] = prof.window_s
        line["breakdown"] = {"device_ops": prof.top_ops(),
                             "idle_gaps": prof.idle_gaps()}
    line["compared"] = {k: {"value": v, "limit": cell.limits.get(k)}
                        for k, v in out.compared.items()}
    return line


def device_kind(device) -> str:
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"


def program_in(root: Path) -> bool:
    """Whether the program under test is the checkout's own."""
    try:
        import kosmosx_torch
    except ImportError:
        return False
    return Path(kosmosx_torch.__file__).resolve().parent.parent == root


def main(args, t0: float, root: Path) -> int:
    import torch

    if not program_in(root):
        print(f"perfbench: the program kosmosx_torch is not in {root}",
              file=sys.stderr)
        return 1
    cell = load_cell(root, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    ctx = Context(cell, args.seed, float(args.seconds), bool(args.trace),
                  torch.device("cuda", 0), t0)
    line = run_cell(cell, ctx)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 1
    for k, v in line["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
