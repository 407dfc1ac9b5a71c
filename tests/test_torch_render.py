"""gsjax_torch's render path against gsjax end to end, on the CPU: the
rasterizer, the committed goldens, edge cases, f16 overflow, the weight
carry-over from a gsjax state, PLY interchange, the budget probe and the
offline-render CLI."""

import dataclasses
import glob
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_camera, make_test_gaussians
from gsjax.data.cameras import Camera as JCamera
from gsjax.ops import RasterizeSettings as JSettings
from gsjax.ops import render as j_render
from gsjax_torch.data.cameras import Camera as TCamera
from gsjax_torch.ops import RasterizeSettings as TSettings
from gsjax_torch.ops import render as t_render
from gsjax_torch.ops import render_naive as t_render_naive

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = sorted(glob.glob(os.path.join(ROOT, "evidence", "goldens", "*.npz")))
COUNTERS = ("num_dropped", "num_mt_capped", "num_tier_capped", "num_tile_capped")
# port backend -> the gsjax backend it stands for
BACKENDS = {"scan": "xla", "kernel": "pallas"}


def t_camera(cam):
    return TCamera(uid=cam.uid, image_name=cam.image_name, R=cam.R, T=cam.T,
                   fov_x=cam.fov_x, fov_y=cam.fov_y, width=cam.width,
                   height=cam.height).to_render_camera("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def j_out(cam, gs, bg, settings, **kw):
    rc = cam.to_render_camera()
    out = jax.jit(lambda *a: j_render(rc, *a, 3, jnp.asarray(bg), settings, **kw))(
        *map(jnp.asarray, gs))
    return {k: np.asarray(v) for k, v in out.items()}


def t_out(cam, gs, bg, settings, **kw):
    with torch.no_grad():
        out = t_render(t_camera(cam), *map(_t, gs), 3, _t(bg), settings,
                       **{k: _t(v) for k, v in kw.items()})
    return {k: v.numpy() for k, v in out.items()}


def assert_two_tier(got, want, name, tol=1e-4):
    """max |diff| <= ``tol``, except where a pair sits on the 1/255 alpha
    cut or the 1e-4 transmittance exit: one implementation can take it and
    the other not (last-ulp exp / product differences), moving a few pixels
    by up to about one minimum contribution — the two-tier rule of
    bench.py: at most 0.1% of the values past ``tol``, none past 6e-3."""
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert np.isfinite(d).all(), name
    past = d > tol
    assert past.mean() <= 1e-3 and d.max() <= 6e-3, (name, d.max(), past.sum())


SETTINGS = {
    "grid": dict(max_pairs=1 << 14, max_tiles_per_gauss=16),
    "compact": dict(max_pairs=1 << 14, max_tiles_per_gauss=16, expansion="compact"),
    "tiered": dict(max_pairs=1 << 14, max_tiles_per_gauss=16, tier_frac=0.875),
}


@pytest.mark.parametrize("case,width,height", [
    ("grid", 64, 64), ("compact", 70, 45), ("tiered", 80, 48)])
def test_render_matches_gsjax_both_backends(case, width, height):
    gs = make_test_gaussians(200, np.random.default_rng(11))
    cam = make_test_camera(width, height, seed=4)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    for t_backend, j_backend in BACKENDS.items():
        jo = j_out(cam, gs, bg, JSettings(backend=j_backend, **SETTINGS[case]))
        to = t_out(cam, gs, bg, TSettings(backend=t_backend, **SETTINGS[case]))
        assert to["render"].shape == (height, width, 3)
        assert_two_tier(to["render"], jo["render"], f"{t_backend} render")
        assert_two_tier(to["final_T"], jo["final_T"], f"{t_backend} final_T")
        np.testing.assert_array_equal(to["radii"], jo["radii"])
        np.testing.assert_array_equal(to["visibility_filter"], jo["visibility_filter"])
        for k in COUNTERS:
            assert int(to[k]) == int(jo[k]), (t_backend, k)


def test_auto_backend_and_gradient_rules():
    """auto -> scan on CPU tensors; both backends are differentiable. The
    kernel backend takes the differentiable compositor (training forward +
    backward + reduction) when a blend input requires grad, and the
    inference compositor otherwise (tests/test_torch_train_composite.py
    holds its gradients against gsjax)."""
    from gsjax_torch.ops import cuda_composite as t_cc

    gs = make_test_gaussians(60, np.random.default_rng(2))
    cam = t_camera(make_test_camera(48, 48))
    grads = {}
    for backend in ("auto", "kernel"):
        means = _t(gs[0]).requires_grad_(True)
        out = t_render(cam, means, *map(_t, gs[1:]), 3, torch.zeros(3),
                       TSettings(backend=backend))
        out["render"].sum().backward()
        assert means.grad is not None and torch.isfinite(means.grad).all()
        assert float(means.grad.abs().max()) > 0
        grads[backend] = means.grad
    scale = float(grads["auto"].abs().max())
    assert float((grads["kernel"] - grads["auto"]).abs().max()) <= 1e-5 * scale
    calls = []
    fwd, infer = t_cc.composite_fwd_plain, t_cc.composite_infer_plain
    t_cc.composite_fwd_plain = lambda *a: calls.append("fwd") or fwd(*a)
    t_cc.composite_infer_plain = lambda *a: calls.append("infer") or infer(*a)
    try:
        with torch.no_grad():
            t_render(cam, means, *map(_t, gs[1:]), 3, torch.zeros(3),
                     TSettings(backend="kernel"))
        t_render(cam, means, *map(_t, gs[1:]), 3, torch.zeros(3),
                 TSettings(backend="kernel"))
    finally:
        t_cc.composite_fwd_plain, t_cc.composite_infer_plain = fwd, infer
    assert calls == ["infer", "fwd"]
    with pytest.raises(ValueError):
        TSettings(backend="pallas")  # the port's names are scan / kernel


# --------------------------------------------------------------------------
# committed goldens (forward only; their gradients wait for training)
# --------------------------------------------------------------------------


def _golden(path):
    z = np.load(path)
    cam = JCamera(
        uid=0, image_name="golden", R=np.eye(3), T=np.zeros(3),
        fov_x=float(z["fov_x"]),
        fov_y=float(z["fov_x"]) * int(z["height"]) / int(z["width"]),
        width=int(z["width"]), height=int(z["height"]),
    )
    gs = tuple(z[k] for k in ("means3d", "scales", "quats", "opacities", "shs"))
    return z, cam, gs


@pytest.mark.parametrize("path", GOLDENS, ids=os.path.basename)
def test_goldens(path):
    z, cam, gs = _golden(path)
    with torch.no_grad():
        out = t_render_naive(t_camera(cam), *map(_t, gs), 3, _t(z["bg"]))
    # as tests/test_goldens.py holds gsjax's oracle
    np.testing.assert_allclose(out["render"].numpy(), z["render"], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(out["final_T"].numpy(), z["final_T"], atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(out["radii"].numpy(), z["radii"])
    for backend in ("scan", "kernel"):
        s = TSettings(max_pairs=1 << 17, max_splats_per_tile=1024, chunk=32,
                      backend=backend)
        out = t_out(cam, gs, z["bg"], s)
        assert int(out["num_dropped"]) == 0
        np.testing.assert_allclose(out["render"], z["render"], atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(out["final_T"], z["final_T"], atol=1e-3, rtol=1e-3)


def test_goldens_present():
    assert len(GOLDENS) >= 2


# --------------------------------------------------------------------------
# edge cases
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["scan", "kernel"])
def test_all_culled_renders_background(backend):
    gs = list(make_test_gaussians(50, np.random.default_rng(3)))
    gs[0] = gs[0] * np.array([1, 1, -1], np.float32)  # all behind the camera
    bg = np.array([0.3, 0.6, 0.9], np.float32)
    out = t_out(make_test_camera(40, 24), gs, bg, TSettings(backend=backend))
    np.testing.assert_array_equal(out["render"], np.broadcast_to(bg, (24, 40, 3)))
    np.testing.assert_array_equal(out["final_T"], np.ones((24, 40), np.float32))
    assert not out["radii"].any() and int(out["num_dropped"]) == 0


@pytest.mark.parametrize("backend", ["scan", "kernel"])
def test_pair_budget_overflow_counted(backend):
    gs = make_test_gaussians(150, np.random.default_rng(5))
    cam = make_test_camera(70, 45, seed=2)
    bg = np.zeros(3, np.float32)
    kw = dict(max_pairs=256, max_tiles_per_gauss=16)
    to = t_out(cam, gs, bg, TSettings(backend=backend, **kw))
    jo = j_out(cam, gs, bg, JSettings(backend=BACKENDS[backend], **kw))
    assert int(to["num_dropped"]) == int(jo["num_dropped"]) > 0
    assert np.isfinite(to["render"]).all()
    assert_two_tier(to["render"], jo["render"], "render")


def test_f16_color_overflow():
    """A color above 65504 overflows the f16 quantization.

    gsjax's XLA scan composites the f16 inf through a dense matmul, so 0 *
    inf = NaN spreads over that channel of every pixel; gsjax's Pallas
    decode works on the bits and reads the overflowed half as 65536, so its
    image stays finite. The port's kernel backend decodes the same way (in
    the kernels and in their plain versions, ``decode_f16_pair``) and
    equals gsjax's Pallas image on every pixel. The port's scan backend
    (pinned, ROADMAP Queue 3) keeps the inf and adds a pair only to the
    pixels it blends into, so exactly the pixels the overflowing gaussian
    covers are inf and every other pixel equals gsjax's Pallas image.
    tests/test_torch_cuda.py holds the kernel to the same on the card."""
    rng = np.random.default_rng(0)
    gs = make_test_gaussians(40, rng)
    cam = make_test_camera(64, 64, seed=1)
    cols = rng.uniform(0.1, 0.9, (40, 3)).astype(np.float32)
    cols[0, 1] = 7e4
    bg = np.zeros(3, np.float32)
    s = dict(max_pairs=1 << 14)
    jx = j_out(cam, gs, bg, JSettings(backend="xla", **s), colors_precomp=cols)
    jp = j_out(cam, gs, bg, JSettings(backend="pallas", **s), colors_precomp=cols)
    assert np.isnan(jx["render"][..., 1]).all()
    assert np.isfinite(jx["render"][..., [0, 2]]).all()
    assert np.isfinite(jp["render"]).all()
    # the pixels gaussian 0 blends into: where its green channel matters
    cols0 = cols.copy()
    cols0[0, 1] = 0.0
    jp0 = j_out(cam, gs, bg, JSettings(backend="pallas", **s), colors_precomp=cols0)
    covered = jp["render"][..., 1] != jp0["render"][..., 1]
    assert covered.sum() > 10 and jp["render"][..., 1].max() > 1e3

    img = t_out(cam, gs, bg, TSettings(backend="kernel", **s), colors_precomp=cols)["render"]
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img[~covered], jp["render"][~covered], atol=1e-5)
    # the covered pixels hold 65536 alpha T: float32 sums of values up to
    # ~6e4 in another order, held relative to their size
    np.testing.assert_allclose(img[covered], jp["render"][covered], rtol=1e-5, atol=1e-5)
    assert img[covered][:, 1].max() > 1e3

    img = t_out(cam, gs, bg, TSettings(backend="scan", **s), colors_precomp=cols)["render"]
    assert not np.isnan(img).any()
    np.testing.assert_array_equal(np.isinf(img).any(-1), covered)
    assert np.isinf(img[covered][:, 1]).all()
    np.testing.assert_allclose(img[~covered], jp["render"][~covered], atol=1e-5)


# --------------------------------------------------------------------------
# weight carry-over from a gsjax state, PLY interchange, budget probe
# --------------------------------------------------------------------------


def _gsjax_state(n=300, capacity=512, seed=0):
    from gsjax.models.gaussians import create_empty

    rng = np.random.default_rng(seed)
    st = create_empty(capacity)
    p = dict(st.params)
    p["xyz"] = p["xyz"].at[:n].set(np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], 1))
    p["scaling"] = p["scaling"].at[:n].set(rng.normal(-2.5, 0.4, (n, 3)))
    p["rotation"] = p["rotation"].at[:n].set(rng.normal(0, 1, (n, 4)))
    p["features_dc"] = p["features_dc"].at[:n].set(rng.normal(0, 0.5, (n, 1, 3)))
    p["features_rest"] = p["features_rest"].at[:n].set(rng.normal(0, 0.1, (n, 15, 3)))
    p["opacity"] = p["opacity"].at[:n].set(rng.normal(0, 1, (n, 1)))
    return dataclasses.replace(st, params=p, active=st.active.at[:n].set(True),
                               active_sh_degree=jnp.int32(3))


def _carry(jstate):
    from gsjax_torch.models.gaussians import state_from_numpy

    return state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.params.items()},
        np.asarray(jstate.active), int(jstate.active_sh_degree),
        max_sh_degree=jstate.max_sh_degree,
        spatial_lr_scale=jstate.spatial_lr_scale, device="cpu",
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
