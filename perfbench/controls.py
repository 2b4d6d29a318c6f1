#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the chip at
the cell's own size.

    python3 perfbench/controls.py --workload <name> --seeds 1,2,3 \
        [--faults half_batch,...] [--seconds 5] [--out <file.jsonl>]

For each seed, in one process: the program's own numbers (a whole run of
the cell with a window of ``--seconds``), the control (the reference at
the precision below the configuration's, ``"control"`` in the cell's
limits file, in the program's place: a serving cell reads it on its run's sample), and
each planted fault named, through a whole run of the cell. One JSON line
a reading, with ``correct`` as the harness judges its numbers against the
cell's limits, on standard output and appended to ``--out``. The
benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    p.add_argument("--controls", default=None,
                   help="precisions to read the control at (default: the "
                        "cell's, in its limits file)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import cache_env

    cache_env(ROOT)
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(ROOT, args.workload)
    driver = harness.load_module(ROOT, "drivers", cell.traffic["driver"])
    faults = [f for f in args.faults.split(",") if f]
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(cell, seed, args.seconds, False, dev,
                              time.perf_counter())
        readings = dict(driver.control(
            ctx, (args.controls or cell.control).split(",")))
        runs = [("program", {})] if "program" not in readings else []
        runs += [(f"fault:{f}", {f: True}) for f in faults]
        for kind, planted in runs:
            ctx = harness.Context(cell, seed, args.seconds, False, dev,
                                  time.perf_counter(), planted)
            readings[kind] = {k: v["value"] for k, v in
                              harness.run_cell(cell, ctx)["compared"].items()}
        for kind, compared in readings.items():
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "reading": kind, "compared": compared,
                               "correct": judged(cell, compared),
                               "device": torch.cuda.get_device_name(0)})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


def judged(cell, compared: dict) -> bool:
    """``correct`` of a reading: its numbers that the cell limits, judged
    as a run's are."""
    from perfbench import harness

    return harness.judge({k: v for k, v in compared.items()
                          if k in cell.limits}, cell.limits)


if __name__ == "__main__":
    sys.exit(main())
