"""A tiny copy of the benchmark's cells for the CPU tests: bench1080's
scene at 3,000 gaussians and 96x64, dispatches of 3 steps."""

from __future__ import annotations

import copy
import json
import os

import torch

from gsbench import harness

REPO = os.path.dirname(harness.ROOT)


def bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def config(name="bench1080") -> dict:
    cfg = harness.load_json("configs", f"{name}.json")
    cfg.update(n_gauss=3000, capacity=4096, width=96, height=64, log_scale=-3.5)
    return cfg


def traffic(kind: str) -> dict:
    tr = copy.deepcopy(harness.load_json("traffic", f"{kind}.json"))
    if kind == "train":
        tr.update(steps_per_dispatch=3)
    else:
        tr.update(sample_mean_gap=2, sample_max=3, trace_frames=3)
    return tr


def run(kind: str, seed: int = 1234, seconds: float = 0.5, trace: bool = False):
    torch.set_num_threads(2)
    workload = f"bench1080.{kind}"
    r = harness.Run(bench(), workload, seed, seconds, trace, "cpu", config=config(),
                    traffic=traffic(kind))
    return r.run()
