"""The correctness check's control and planted faults, at a size a test
run holds, on the CPU in bfloat16 like the cells.

The control is the reference put in the program's place at the precision
below the configuration's (the cell's limits file names it): on each of a
few seeds the harness must judge it not correct under the cell's limits.
The planted faults drive the
rest of a run (the harness's look for a chip skipped) with the timed path
broken underneath, and the run must come out not correct."""

import time

import pytest
import torch

from perfbench import controls, harness
from perfbench.tests import perfbench_tiny as tiny

SEEDS = (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3)


def _cell(kind):
    c = tiny.cell(kind)
    c.config["compute_dtype"] = "bfloat16"
    if kind == "score":
        # a decoder deep and wide enough that a precision's error grows
        # through it as it does at the cell's size: at two layers of 32
        # the int4 control's logits lie within the cell's limits
        c.config["decoder"].update(layers=8, embed_dim=64, ffn_dim=256)
    if kind == "serve":
        # the published vocabulary, for the near ties a precision flips,
        # and a sample of some hundreds of served tokens
        c.config["decoder"].update(layers=4, embed_dim=64, ffn_dim=256,
                                   vocab_size=32002)
        c.traffic["check_requests"] = 16
        c.traffic["new_tokens"] = {"min": 8, "max": 16}
    return c


def _ctx(c, seed, faults=None):
    # one thread, as a run has: a pool of threads in each of several test
    # processes would leave the serving window a few steps
    torch.set_num_threads(1)
    # a serving window long enough to finish a sample of requests on a
    # host that other test processes share
    seconds = 8.0 if c.traffic["driver"] == "serve" else 0.5
    return harness.Context(c, seed, seconds, False, torch.device("cpu"),
                           time.perf_counter(), faults or {})


@pytest.mark.parametrize("kind", ["train", "score", "serve"])
def test_control_is_not_correct(kind):
    c = _cell(kind)
    driver = harness.load_module(tiny.ROOT, "drivers", kind)
    for seed in SEEDS:
        got = driver.control(_ctx(c, seed), [c.control])
        ctl = got[f"control:{c.control}"]
        assert controls.judged(c, ctl) is False, (seed, ctl)


@pytest.mark.parametrize("kind,fault", [
    ("train", "unchanged_state"), ("train", "half_batch"),
    ("train", "ascent"),
    ("score", "alter_answer"), ("serve", "alter_token")])
def test_a_planted_fault_is_not_correct(kind, fault):
    c = _cell(kind)
    assert harness.run_cell(c, _ctx(c, SEEDS[0]))["correct"] is True
    line = harness.run_cell(c, _ctx(c, SEEDS[0], {fault: True}))
    assert line["correct"] is False, line["compared"]
