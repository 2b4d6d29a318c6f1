#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's files are found by the names in
``BENCHMARK.json`` (``perfbench/harness.py``). Without as many CUDA devices
as the cell asks for, it prints no result and exits 1.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_env(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds
    its own CUDA library under ``kosmosx_torch/_build/``), no Flax backend
    for any library that would load one, and one thread for the host's own
    tensor work: the host only launches work on the card, and a pool of
    worker threads per process only adds jitter on a shared host."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    cache = root / "perfbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    return harness.main(args, T0, ROOT)


if __name__ == "__main__":
    sys.exit(main())
