"""The trainer's budget probe (``train/loop.py:_probe_initial_budgets``,
training) on the CPU: it measures every training camera, where gsjax's
measures four, so a camera the four skip, whose footprint is the widest,
is held by the cap and the budget it sizes, and a chained dispatch over it
drops no pair; a compact expansion starts its tile cap at the frame's tile
count, as the overflow reaction ends, and a grid keeps the probed cap; the
probe is a span with two counters of ``utils.profiling``'s registry."""

import dataclasses
import importlib.util
import math
import os
import sys
import types

import pytest
import torch

from gsbench import harness
from gsbench.reference.cameras import lookat_pose
from gsjax_torch.configs import OptimizationParams
from gsjax_torch.data.cameras import Camera, stack_render_cameras
from gsjax_torch.models.gaussians import GaussianState, activated
from gsjax_torch.ops.projection import preprocess
from gsjax_torch.train.loop import (
    _probe_initial_budgets, default_rasterize_settings, frame_tile_cap,
)
from gsjax_torch.utils import profiling
from test_torch_densify import one_torch_thread  # noqa: F401

W, H = 128, 96  # 8 x 6 tiles: the frame's cap is 64
CAMS = 8
SKIPPED = 5  # gsjax's four: cameras[::2][:4] = 0, 2, 4, 6


def _scene(wide: bool, capacity=16384, seed=0):
    """Small gaussians around the origin seen by 8 cameras on a ring of
    radius 4; with ``wide``, six wide ones 0.8 m in front of camera 5,
    outside the other cameras' frustums."""
    gen = torch.Generator().manual_seed(seed)
    poses = [lookat_pose((4 * math.cos(2 * math.pi * i / CAMS),
                          4 * math.sin(2 * math.pi * i / CAMS), 0.0),
                         (0.0, 0.0, 0.0), 1.0, W, H) for i in range(CAMS)]
    n = 300
    xyz = 2 * torch.rand((n, 3), generator=gen) - 1
    scaling = torch.full((n, 3), -3.2)
    if wide:
        eye = torch.tensor([4 * math.cos(2 * math.pi * SKIPPED / CAMS),
                            4 * math.sin(2 * math.pi * SKIPPED / CAMS), 0.0])
        xyz = torch.cat([xyz, 0.8 * eye + 0.1 * torch.randn((6, 3), generator=gen)])
        scaling = torch.cat([scaling, torch.full((6, 3), math.log(0.1))])
    m = xyz.shape[0]
    z = torch.zeros
    params = {"xyz": z(capacity, 3), "features_dc": z(capacity, 1, 3),
              "features_rest": z(capacity, 15, 3), "scaling": z(capacity, 3),
              "rotation": z(capacity, 4), "opacity": z(capacity, 1)}
    params["rotation"][:, 0] = 1.0
    params["xyz"][:m], params["scaling"][:m] = xyz, scaling
    params["features_dc"][:m] = 0.5 * torch.randn((m, 1, 3), generator=gen)
    params["opacity"][:m] = 2.0
    active = torch.zeros(capacity, dtype=torch.bool)
    active[:m] = True
    zc = torch.zeros(capacity)
    state = GaussianState(params=params, active=active, max_radii2d=zc.clone(),
                          xyz_grad_accum=zc.clone(), denom=zc.clone(), active_sh_degree=0,
                          spatial_lr_scale=4.0)
    cams = [Camera(uid=i, image_name=f"{i:04d}", R=p["R"], T=p["T"], fov_x=p["fov_x"],
                   fov_y=p["fov_y"], width=W, height=H) for i, p in enumerate(poses)]
    return state, cams


def _footprints(state, cams):
    """(widest footprint, pairs) of each camera."""
    out = []
    with torch.no_grad():
        for c in cams:
            tt = preprocess(*activated(state), c.to_render_camera("cpu"),
                            state.active_sh_degree, active_mask=state.active).tiles_touched
            out.append((int(tt.max()), int(tt.to(torch.int64).sum())))
    return out


def _four(cams):
    return cams[:: max(1, len(cams) // 4)][:4]


def test_training_probe_covers_the_camera_four_skip(one_torch_thread):  # noqa: F811
    state, cams = _scene(wide=True)
    feet = _footprints(state, cams)
    widest, pairs = feet[SKIPPED]
    # the scene is what the test needs: camera 5 has the widest footprint
    # and the most pairs, beyond the heuristic's cap, and gsjax's four skip it
    assert SKIPPED not in [c.uid for c in _four(cams)]
    assert all(widest > f[0] and pairs > f[1] for i, f in enumerate(feet) if i != SKIPPED)
    base = default_rasterize_settings(W, H, state.capacity)
    assert widest > base.max_tiles_per_gauss
    s = _probe_initial_budgets(base, state, cams, W, H)
    assert s.expansion == "grid"
    assert s.max_tiles_per_gauss >= widest and s.max_pairs >= 2 * pairs
    # gsjax's sample, the four cameras alone, sizes a cap below it
    four = _probe_initial_budgets(base, state, _four(cams), W, H)
    assert four.max_tiles_per_gauss < widest


@pytest.mark.parametrize("size,cap", [((W, H), 64), ((96, 64), 32), ((1297, 840), 8192),
                                      ((1557, 1038), 8192), ((1920, 1080), 8192)])
def test_frame_tile_cap_is_where_the_reaction_ends(size, cap):
    assert frame_tile_cap(*size) == cap == harness.frame_tile_cap(*size)


@pytest.mark.parametrize("expansion", ["compact", "grid"])
def test_compact_cap_starts_at_the_frame_and_grid_keeps_the_probe(one_torch_thread,  # noqa: F811
                                                                  expansion):
    state, cams = _scene(wide=False)
    base = default_rasterize_settings(W, H, state.capacity)
    if expansion == "compact":  # a budget far below the grid's slots
        base = dataclasses.replace(base, max_pairs=1 << 10)
    s = _probe_initial_budgets(base, state, cams, W, H)
    assert s.expansion == expansion
    widest = max(f[0] for f in _footprints(state, cams))
    probed = max(2 ** math.ceil(math.log2(widest)), base.max_tiles_per_gauss)
    assert probed < frame_tile_cap(W, H)
    want = frame_tile_cap(W, H) if expansion == "compact" else probed
    assert s.max_tiles_per_gauss == want
    # inference keeps the probed cap under either expansion
    inf = _probe_initial_budgets(base, state, cams, W, H, inference=True, every_view=True)
    assert inf.max_tiles_per_gauss == probed


def _dispatch_metrics(state, cams, settings, order):
    from gsjax_torch.train.optim import make_optimizer
    from gsjax_torch.train.step import TrainConfig, make_train_step_chained

    tx = make_optimizer(OptimizationParams(), 4.0)
    opt = tx.init(state.params)
    targets = torch.full((len(cams), H, W, 3), 128, dtype=torch.uint8)
    chained = make_train_step_chained(tx, stack_render_cameras(cams, "cpu"), targets,
                                      TrainConfig(settings=settings, extent=4.0), len(order))
    return {k: int(v) for k, v in chained(state, opt, order)[2].items()
            if k.startswith("num_")}


def test_chained_dispatch_over_the_skipped_camera_drops_no_pair(one_torch_thread):  # noqa: F811
    order = [SKIPPED, 1, SKIPPED]
    state, cams = _scene(wide=True)
    base = default_rasterize_settings(W, H, state.capacity)
    got = _dispatch_metrics(state, cams, _probe_initial_budgets(base, state, cams, W, H),
                            order)
    assert got["num_dropped_pairs"] == 0 and got["num_mt_capped_pairs"] == 0
    # sized on gsjax's four cameras, the same dispatch drops pairs to the cap
    state, cams = _scene(wide=True)
    four = _probe_initial_budgets(base, state, _four(cams), W, H)
    got = _dispatch_metrics(state, cams, four, order)
    assert got["num_mt_capped_pairs"] > 0 and got["num_dropped_pairs"] > 0


def test_compact_cap_holds_a_footprint_that_widens_in_training(one_torch_thread):  # noqa: F811
    state, cams = _scene(wide=False)
    base = dataclasses.replace(default_rasterize_settings(W, H, state.capacity),
                               max_pairs=1 << 10)
    s = _probe_initial_budgets(base, state, cams, W, H)
    probed = dataclasses.replace(s, max_tiles_per_gauss=base.max_tiles_per_gauss)
    assert s.expansion == "compact" and max(f[0] for f in _footprints(state, cams)) <= 16
    for settings, drops in ((s, False), (probed, True)):
        state, cams = _scene(wide=False)
        with torch.no_grad():  # training widened one gaussian past the probed cap
            state.params["scaling"][0] = math.log(0.5)
        assert _footprints(state, cams)[0][0] > probed.max_tiles_per_gauss
        got = _dispatch_metrics(state, cams, settings, [0, 1, 0])
        assert (got["num_mt_capped_pairs"] > 0) == drops
        assert (got["num_dropped_pairs"] > 0) == drops


def test_probe_records_its_span_and_counters(one_torch_thread):  # noqa: F811
    state, cams = _scene(wide=True)
    base = default_rasterize_settings(W, H, state.capacity)

    def totals():
        rec = profiling.records()["untraced"]
        return (rec["spans"].get("budgets.probe", {}).get("count", 0),
                rec["counters"].get("probe.views", 0), rec["counters"].get("probe.pairs", 0))

    before = totals()
    _probe_initial_budgets(base, state, cams, W, H)
    after = totals()
    assert after[0] - before[0] == 1
    assert after[1] - before[1] == CAMS
    assert after[2] - before[2] == sum(f[1] for f in _footprints(state, cams))
    # the inference probe is not the training probe's span
    _probe_initial_budgets(base, state, cams, W, H, inference=True, every_view=True)
    assert totals() == after


def test_benchmark_reader_reads_the_probe_span(monkeypatch, one_torch_thread):  # noqa: F811
    path = os.path.join(harness.ROOT, "metrics", "budget_probe_ms.train.py")
    spec = importlib.util.spec_from_file_location("reader_budget_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    state, cams = _scene(wide=True)
    _probe_initial_budgets(default_rasterize_settings(W, H, state.capacity), state, cams, W, H)
    span = profiling.records()["untraced"]["spans"]["budgets.probe"]
    assert mod.read({"kind": "train"}) == pytest.approx(1e3 * span["seconds"])
    assert mod.read({"kind": "view"}) is None
    # an empty registry, and a program without one, read nothing
    monkeypatch.setattr(profiling, "records", profiling.Registry().records)
    assert mod.read({"kind": "train"}) is None
    monkeypatch.setitem(sys.modules, "gsjax_torch.utils.profiling",
                        types.ModuleType("gsjax_torch.utils.profiling"))
    assert mod.read({"kind": "train"}) is None
