"""Seeded traffic and scenes are deterministic, and every seed gives the
same sizes; the window's arithmetic."""

import itertools
import statistics

import pytest
import torch

from gsbench import harness
from gsbench.tests import tiny


def test_camera_order_is_the_seeds():
    a = list(itertools.islice(harness.shuffled_stack(2**31 + 17, 4), 40))
    b = list(itertools.islice(harness.shuffled_stack(2**31 + 17, 4), 40))
    c = list(itertools.islice(harness.shuffled_stack(5, 4), 40))
    assert a == b and a != c
    for i in range(0, 40, 4):  # each camera once a pass, as the trainer's stack
        assert sorted(a[i:i + 4]) == [0, 1, 2, 3]


def test_sample_positions_are_the_seeds():
    assert harness.sample_positions(9, 150, 12) == harness.sample_positions(9, 150, 12)
    assert len(harness.sample_positions(9, 150, 12)) == 12


@pytest.mark.parametrize("scene", ["bench1080", "garden3m"])
def test_scene_is_the_seeds(scene):
    cfg = harness.load_json("configs", f"{scene}.json")
    cfg.update(n_gauss=20000, capacity=32768)
    build = harness.scene_maker(cfg["scene"])
    a = build(cfg, 2**31 + 5, torch.device("cpu"))
    b = build(cfg, 2**31 + 5, torch.device("cpu"))
    c = build(cfg, 11, torch.device("cpu"))
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k])
        assert a["params"][k].shape == c["params"][k].shape
    assert not torch.equal(a["params"]["xyz"], c["params"]["xyz"])
    assert int(a["active"].sum()) == int(c["active"].sum()) == 20000
    assert len(a["train_poses"]) == len(c["train_poses"])
    pa = list(itertools.islice(a["view_path"](3), 50))
    assert pa == list(itertools.islice(b["view_path"](3), 50))
    assert all(0 <= k < len(a["view_poses"]) for k in pa)


def test_window_arithmetic():
    # a rate over the whole window, whatever the items' own times
    assert harness.per_item_ms(2.0, 50) == pytest.approx(40.0)
    lat = [0.010] * 95 + [0.050] * 5
    assert harness.p95_ms(lat) == pytest.approx(1e3 * statistics.quantiles(lat, n=100)[94])
    assert harness.p95_ms(list(range(1, 101))) == pytest.approx(1e3 * 95.95)
    assert harness.p95_ms([0.02]) == pytest.approx(20.0)


def test_targets_are_the_seeds():
    r1 = harness.Run(tiny.bench(), "bench1080.train", 7, 0, False, "cpu", limits={},
                     config=tiny.config(), traffic=tiny.traffic("train"))
    sc = r1.scene()
    from gsbench.reference.cameras import camera_tensors

    cams = [camera_tensors(p, r1.dev) for p in sc["train_poses"][:1]]
    assert torch.equal(r1.render_targets(sc, cams, "count_index"),
                       r1.render_targets(r1.scene(), cams, "count_index"))
