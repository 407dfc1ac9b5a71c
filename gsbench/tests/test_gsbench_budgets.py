"""The training cells' budgets: a compact expansion's tile cap starts at
the trainer's overflow ceiling, a grid's stays as the probe sized it."""

import dataclasses
import types

import pytest

from gsbench import harness
from gsbench.tests import tiny


@pytest.mark.parametrize("size,cap", [((1920, 1080), 8192), ((1297, 840), 8192),
                                      ((96, 64), 32), ((16, 16), 2)])
def test_frame_tile_cap(size, cap):
    assert harness.frame_tile_cap(*size) == cap


@pytest.mark.parametrize("expansion,want", [("compact", 32), ("grid", 4)])
def test_trainer_budgets_tile_cap(monkeypatch, expansion, want):
    from gsjax_torch.train import loop

    monkeypatch.setattr(loop, "_probe_initial_budgets", lambda s, *a, **k: dataclasses.replace(
        s, expansion=expansion, max_tiles_per_gauss=4))
    r = harness.Run(tiny.bench(), "bench1080.train", 7, 0.1, False, "cpu",
                    config=tiny.config(), traffic=tiny.traffic("train"))
    budgets = r.cfg["train_budgets"]
    assert budgets["tile_cap"] == "reaction_ceiling"
    s = r.settings(budgets, types.SimpleNamespace(capacity=4096), [], 96, 64, train=True)
    assert s.max_tiles_per_gauss == want
