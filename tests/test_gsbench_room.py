"""The benchmark's indoor scene (``gsbench/scenes/room_inside.py``, the
configuration ``room1m5``) at a tiny size on the CPU: the scene is the
seed's, every training pose stands inside the room and outside the
furniture and sees the central group; and the cell ``room1m5.train`` run
through the harness, the program's plain path under its own budgets
against the plain reference, comes out correct with no failed operation;
a program whose training probe cannot hold the scene is refused before
set-up."""

import numpy as np
import pytest
import torch

from gsbench import harness
from gsbench.scenes import room_inside
from gsbench.tests import tiny
from test_torch_densify import one_torch_thread  # noqa: F401


def _config():
    cfg = harness.load_json("configs", "room1m5.json")
    cfg.update(n_gauss=4000, capacity=8192, width=96, height=64, views=6)
    return cfg


def test_same_seed_same_scene():
    a = room_inside.build(_config(), 11, "cpu")
    b = room_inside.build(_config(), 11, "cpu")
    c = room_inside.build(_config(), 12, "cpu")
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert not torch.equal(a["params"]["xyz"], c["params"]["xyz"])
    assert torch.equal(a["active"], b["active"]) and int(a["active"].sum()) == 4000
    for p, q in zip(a["train_poses"], b["train_poses"]):
        assert np.array_equal(p["R"], q["R"]) and np.array_equal(p["T"], q["T"])
    assert all(torch.isfinite(v).all() for v in a["params"].values())


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_poses_stand_inside_the_room_and_see_the_central_group(seed):
    cfg = harness.load_json("configs", "room1m5.json")
    poses = room_inside.train_poses(cfg, seed)
    assert len(poses) == cfg["views"] == 96
    half = np.asarray(cfg["room"]) / 2
    table = np.asarray(room_inside.FURNITURE[0][0]) + [0.0, 0.0, room_inside.FURNITURE[0][1][2]]
    for p in poses:
        eye = -p["R"] @ p["T"]
        assert abs(eye[0]) < half[0] and abs(eye[1]) < half[1] and 0 < eye[2] < 2 * half[2]
        for c, h, _ in room_inside.FURNITURE:
            assert (np.abs(eye - np.asarray(c)) > np.asarray(h)).any()
        q = p["R"].T @ table + p["T"]  # the table top's centre in the camera
        assert q[2] > 0.2
        assert abs(q[0] / q[2]) < np.tan(p["fov_x"] / 2)
        assert abs(q[1] / q[2]) < np.tan(p["fov_y"] / 2)


def test_surfaces_hold_gaussians_where_cameras_see_them():
    sc = room_inside.build(_config(), 7, "cpu")
    n = int(sc["active"].sum())
    xyz = sc["params"]["xyz"][:n]
    half = torch.tensor(harness.load_json("configs", "room1m5.json")["room"]) / 2
    assert (xyz[:, :2].abs() <= half[:2] + 1e-3).all()
    assert (xyz[:, 2] >= -1e-3).all() and (xyz[:, 2] <= 2 * half[2] + 1e-3).all()
    # the tail: about 2% of the gaussians 8-20x wider than the rest
    width = sc["params"]["scaling"][:n, :2].exp().amax(1)
    op = torch.sigmoid(sc["params"]["opacity"][:n, 0])
    faint = op < 0.45
    assert 0.01 < float(faint.float().mean()) < 0.03
    assert float(width[faint].median()) > 5 * float(width[~faint].median())


def test_room_cell_runs_correct_against_the_reference(one_torch_thread):  # noqa: F811
    bench = tiny.bench()
    assert any(w["name"] == "room1m5.train" for w in bench["workloads"])
    out = harness.Run(bench, "room1m5.train", 2100000007, 0.5, False, "cpu",
                      config=_config(), traffic=tiny.traffic("train")).run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"train_step_ms", "setup_s"}


def test_scene_refuses_a_program_whose_probe_cannot_hold_it(monkeypatch):
    from gsjax_torch.train import loop

    room_inside.require_training_probe()  # this program's probe holds every view
    monkeypatch.delattr(loop, "frame_tile_cap")
    with pytest.raises(SystemExit, match="measures four cameras"):
        room_inside.build(_config(), 11, "cpu")
