"""A tiny configuration and tiny mixes of the three window drivers, for
running the harness on the CPU."""

from __future__ import annotations

import copy
import time
import json
from pathlib import Path

import torch

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]

CONFIG = {
    "name": "tiny", "weights": "bfloat16", "compute_dtype": "float32",
    "vision": {"image_size": 28, "patch_size": 14, "hidden_dim": 32,
               "layers": 2, "heads": 2, "mlp_dim": 64,
               "layer_norm_eps": 1e-5, "activation": "gelu"},
    "resampler": {"dim": 32, "depth": 2, "dim_head": 8, "heads": 2,
                  "num_latents": 4, "num_media_embeds": 5, "ff_mult": 4},
    "decoder": {"vocab_size": 64, "embed_dim": 32, "ffn_dim": 64,
                "layers": 2, "heads": 2, "max_positions": 128,
                "padding_idx": 1, "dropout": 0.0, "attention_dropout": 0.0,
                "activation_dropout": 0.0, "activation": "gelu",
                "subln": True, "multiway": True, "xpos_rel_pos": True,
                "xpos_scale_base": 512, "scale_embedding": True,
                "activation_fp32": True},
    "image_embed_len": 4, "splice_index": 2, "parity_double_scale": True,
}

TRAFFIC = {
    "train": {"driver": "train", "batch": 2, "text_len": 12,
              "master_weights": "float32", "optimizer": "lion",
              "learning_rate": 1e-3, "weight_decay": 0.1, "beta1": 0.9,
              "beta2": 0.95, "grad_clip": 1.0, "remat_policy": "dots",
              "freeze": ["clip"], "check_steps": 3, "profile_steps": 1},
    "score": {"driver": "score", "batch": 2, "text_len": 12,
              "keep_among": 2, "profile_steps": 1},
    "serve": {"driver": "serve", "clients": 4, "max_batch": 4,
              "max_prompt_len": 16, "max_len": 48,
              "decode_attn_kernel": True, "shape_seed": 3, "requests": 512,
              "prompt": {"dist": "lognormal", "median": 8, "sigma": 0.5,
                         "min": 4, "max": 16},
              "image_share": 0.25, "new_tokens": {"min": 2, "max": 6},
              "check_requests": 3, "profile_steps": 2},
}

WORKLOADS = {"train": "kosmosx.train-mm-b4", "score": "kosmosx-w8.score-mm-b6",
             "serve": "kosmosx.serve-long-c128"}


def cell(kind: str, weights: str = None) -> harness.Cell:
    """The benchmark's cell of driver ``kind`` at the tiny sizes, in
    float32 (the W8 cell in its own weights)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = WORKLOADS[kind]
    w = next(x for x in bench["workloads"] if x["name"] == name)
    cfg = copy.deepcopy(CONFIG)
    cfg["weights"] = weights or ("w8" if kind == "score" else "bfloat16")
    limits = json.loads((ROOT / "perfbench" / "limits"
                         / f"{name}.json").read_text())
    return harness.Cell(ROOT, bench, w, cfg, copy.deepcopy(TRAFFIC[kind]),
                        limits["limits"], limits["control"])


def run(kind: str, *, seed: int = 2 ** 31 + 7, seconds: float = 0.5,
        trace: bool = False, faults=None, **kw) -> dict:
    c = cell(kind, **kw)
    ctx = harness.Context(c, seed, seconds, trace, torch.device("cpu"),
                          time.perf_counter(),
                          faults or {})
    return harness.run_cell(c, ctx)
