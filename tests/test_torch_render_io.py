"""gsjax_torch's render path against gsjax, on the CPU, where it meets
files and models: the weight carry-over from a gsjax state, PLY
interchange, the budget probe and the offline-render CLI (moved here from
``tests/test_torch_render.py`` so that the two halves run on two test
workers)."""

import dataclasses
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import make_test_camera
from gsjax.ops import RasterizeSettings as JSettings
from gsjax_torch.data.cameras import Camera as TCamera
from gsjax_torch.ops import RasterizeSettings as TSettings
from test_torch_render import (  # noqa: F401
    _carry, _gsjax_state, _t, assert_two_tier, one_torch_thread, t_camera,
)


def test_weight_carry_over_renders_like_gsjax():
    from gsjax.train.step import TrainConfig as JCfg
    from gsjax.train.step import make_render_fn as j_make
    from gsjax.train.step import render_state as j_render_state
    from gsjax_torch.models.gaussians import state_to_numpy
    from gsjax_torch.train.step import TrainConfig as TCfg
    from gsjax_torch.train.step import make_render_fn as t_make
    from gsjax_torch.train.step import render_state as t_render_state

    jstate = _gsjax_state()
    tstate = _carry(jstate)
    back = state_to_numpy(tstate)
    for k, v in jstate.params.items():
        np.testing.assert_array_equal(back["params"][k], np.asarray(v))
    np.testing.assert_array_equal(back["active"], np.asarray(jstate.active))
    assert back["active_sh_degree"] == 3

    cam = make_test_camera(72, 40, seed=6)
    bg = jnp.asarray([0.0, 0.5, 1.0])
    kw = dict(max_pairs=1 << 14)
    jo = jax.jit(lambda s: j_render_state(s, cam.to_render_camera(), bg,
                                          JSettings(**kw)))(jstate)
    with torch.no_grad():
        to = t_render_state(tstate, t_camera(cam), _t(bg), TSettings(**kw))
    assert_two_tier(to["render"].numpy(), np.asarray(jo["render"]), "render")
    np.testing.assert_array_equal(to["radii"].numpy(), np.asarray(jo["radii"]))

    # make_render_fn with its toggles, both ways of computing SH / cov3D
    for toggles in ({}, {"shs_python": True, "cov3d_python": True}):
        jimg, jdrop = j_make(JCfg(settings=JSettings(**kw)), with_stats=True,
                             as_uint8=True)(jstate, cam.to_render_camera(), bg, 0.9,
                                            **toggles)
        timg, tdrop = t_make(TCfg(settings=TSettings(**kw)), with_stats=True,
                             as_uint8=True)(tstate, t_camera(cam), _t(bg), 0.9,
                                            **toggles)
        assert timg.dtype == torch.uint8 and int(tdrop) == int(jdrop)
        d = np.abs(timg.numpy().astype(int) - np.asarray(jimg).astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-2, toggles


def test_ply_roundtrip_between_packages(tmp_path):
    from gsjax.models.gaussians import load_gaussian_ply as j_load
    from gsjax.models.gaussians import save_gaussian_ply as j_save
    from gsjax_torch.models.gaussians import load_gaussian_ply as t_load
    from gsjax_torch.models.gaussians import save_gaussian_ply as t_save

    jstate = _gsjax_state(n=100, capacity=128)
    j_save(jstate, tmp_path / "from_gsjax.ply")
    tstate = t_load(tmp_path / "from_gsjax.ply", device="cpu")
    assert tstate.active_sh_degree == 3 and int(tstate.active.sum()) == 100
    for k, v in jstate.params.items():
        np.testing.assert_array_equal(tstate.params[k][:100].numpy(), np.asarray(v)[:100])
    t_save(tstate, tmp_path / "from_port.ply")
    back = j_load(tmp_path / "from_port.ply")
    for k, v in jstate.params.items():
        np.testing.assert_array_equal(np.asarray(back.params[k])[:100], np.asarray(v)[:100])
    # byte-compatible files
    assert (tmp_path / "from_gsjax.ply").read_bytes() == (tmp_path / "from_port.ply").read_bytes()


def test_budget_probe_matches_gsjax(capsys):
    from gsjax.train.loop import probe_rasterize_settings as j_probe
    from gsjax_torch.train.loop import probe_rasterize_settings as t_probe

    jstate = _gsjax_state(seed=3)
    jcams = [make_test_camera(80, 48, seed=s) for s in range(5)]
    tcams = [TCamera(uid=c.uid, image_name=c.image_name, R=c.R, T=c.T, fov_x=c.fov_x,
                     fov_y=c.fov_y, width=c.width, height=c.height) for c in jcams]
    js = j_probe(jstate, jcams, 80, 48)
    ts = t_probe(_carry(jstate), tcams, 80, 48)
    for f in dataclasses.fields(js):
        want = getattr(js, f.name)
        want = {"xla": "scan", "pallas": "kernel"}.get(want, want)
        assert getattr(ts, f.name) == want, f.name


def test_budget_probe_of_every_view():
    """``every_view``: the probe measures all the cameras (render_bench's,
    which refuses to print after a drop), not gsjax's four of them. A fifth
    camera moved up to the scene, whose gaussians span more tiles, is seen
    only so; its budgets cover every view's pairs and widest gaussian."""
    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.ops.projection import preprocess
    from gsjax_torch.train.loop import probe_rasterize_settings as t_probe

    state = _carry(_gsjax_state(seed=3))
    cams = [make_test_camera(640, 384, seed=s) for s in range(4)]
    near = dataclasses.replace(cams[0], T=cams[0].T + np.array([0.0, 0.0, -3.0]))
    tcams = [TCamera(uid=c.uid, image_name=c.image_name, R=c.R, T=c.T, fov_x=c.fov_x,
                     fov_y=c.fov_y, width=c.width, height=c.height) for c in cams + [near]]
    four = t_probe(state, tcams, 640, 384)
    every = t_probe(state, tcams, 640, 384, every_view=True)
    with torch.no_grad():
        touched = [preprocess(*activated(state), c.to_render_camera("cpu"), 3,
                              active_mask=state.active).tiles_touched for c in tcams]
    assert every.max_tiles_per_gauss > four.max_tiles_per_gauss
    assert every.max_tiles_per_gauss >= max(int(t.max()) for t in touched)
    assert every.max_pairs >= 1.5 * max(int(t.sum()) for t in touched)
    assert t_probe(state, tcams[:4], 640, 384, every_view=True) == t_probe(state, tcams[:4],
                                                                          640, 384)


# --------------------------------------------------------------------------
# the offline-render CLI
# --------------------------------------------------------------------------


def test_render_cli_matches_gsjax(tmp_path):
    from PIL import Image

    import render as j_cli
    from fixtures import make_blender_scene
    from gsjax.configs import ModelParams, save_cfg_args
    from gsjax.models.gaussians import create_empty, save_gaussian_ply
    from gsjax.utils.math import inverse_sigmoid
    from gsjax_torch import render as t_cli

    scene = str(tmp_path / "scene")
    means, scales, quats, opac, shs, _ = make_blender_scene(
        scene, n_train=2, n_test=0, width=64, height=64)
    n = means.shape[0]
    st = create_empty(64)
    p = dict(st.params)
    p["xyz"] = p["xyz"].at[:n].set(means)
    p["scaling"] = p["scaling"].at[:n].set(np.log(scales))
    p["rotation"] = p["rotation"].at[:n].set(quats)
    p["opacity"] = p["opacity"].at[:n, 0].set(np.asarray(inverse_sigmoid(opac)))
    p["features_dc"] = p["features_dc"].at[:n].set(shs[:, :1])
    p["features_rest"] = p["features_rest"].at[:n].set(shs[:, 1:])
    st = dataclasses.replace(st, params=p, active=st.active.at[:n].set(True))
    models = {}
    for name in ("gsjax", "port"):
        m = str(tmp_path / name)
        os.makedirs(os.path.join(m, "point_cloud", "iteration_5"))
        save_gaussian_ply(st, os.path.join(m, "point_cloud", "iteration_5",
                                           "point_cloud.ply"))
        save_cfg_args(m, ModelParams(source_path=scene, model_path=m))
        models[name] = m
    stdout = sys.stdout
    try:
        j_cli.main(["-m", models["gsjax"], "--quiet"])
        t_cli.main(["-m", models["port"], "--quiet", "--device", "cpu"])
    finally:
        sys.stdout = stdout  # both wrap stdout (safe_state)
    shutil.rmtree(os.path.join(scene, "train"))  # only the renders remain to compare
    for name in ("renders", "gt"):
        jdir = os.path.join(models["gsjax"], "train", "ours_5", name)
        tdir = os.path.join(models["port"], "train", "ours_5", name)
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
            "00000.png", "00001.png"]
        for f in os.listdir(jdir):
            a = np.asarray(Image.open(os.path.join(jdir, f))).astype(int)
            b = np.asarray(Image.open(os.path.join(tdir, f))).astype(int)
            assert a.shape == b.shape == (64, 64, 3)
            assert (np.abs(a - b) <= 1).mean() >= 0.999, (name, f)
            if name == "renders":
                assert a.std() > 1  # the model is on screen
