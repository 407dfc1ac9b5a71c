"""gsjax_torch's math, SH, camera and data-reading modules against gsjax on
the CPU (same numpy inputs from a seed)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.utils import math as jm
from gsjax.utils import sh as jsh
from gsjax_torch.utils import math as tm
from gsjax_torch.utils import sh as tsh

sys.path.insert(0, os.path.dirname(__file__))


def _t(x):
    return torch.from_numpy(np.array(x))


def _quats_scales(n=200, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (n, 4)).astype(np.float32)
    q[0] = 0.0  # a padding slot: safe_normalize keeps it finite
    s = np.exp(rng.normal(-2, 0.5, (n, 3))).astype(np.float32)
    return q, s


@pytest.mark.parametrize("scale_modifier", [1.0, 0.7])
def test_covariance_functions_match_gsjax(scale_modifier):
    q, s = _quats_scales()
    np.testing.assert_allclose(tm.safe_normalize(_t(q)).numpy(),
                               np.asarray(jm.safe_normalize(jnp.asarray(q))),
                               rtol=1e-6, atol=1e-7)
    # entries are sums of products of terms up to ~0.05; where they cancel,
    # the last-ulp differences of the normalized quaternion (XLA's rsqrt vs
    # torch's) leave ~1e-8 absolute
    tol = dict(rtol=1e-5, atol=1e-7)
    c6 = tm.covariance6(_t(s), _t(q), scale_modifier).numpy()
    np.testing.assert_allclose(
        c6, np.asarray(jm.covariance6(jnp.asarray(s), jnp.asarray(q), scale_modifier)),
        **tol)
    full = tm.build_covariance(_t(s), _t(q), scale_modifier)
    np.testing.assert_allclose(
        full.numpy(),
        np.asarray(jm.build_covariance(jnp.asarray(s), jnp.asarray(q), scale_modifier)),
        **tol)
    np.testing.assert_allclose(tm.strip_symmetric(full).numpy(), c6, **tol)
    assert np.isfinite(c6).all()


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_gsjax(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(0, 0.5, (100, 16, 3)).astype(np.float32)
    d = rng.normal(0, 1, (100, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(
        tsh.eval_sh(_t(sh), _t(d), degree).numpy(),
        np.asarray(jsh.eval_sh(jnp.asarray(sh), jnp.asarray(d), degree)),
        rtol=1e-5, atol=1e-6)
    rgb = rng.uniform(0, 1, (10, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh(_t(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))), rtol=1e-6)
    assert tsh.num_sh_coeffs(degree) == jsh.num_sh_coeffs(degree)


def test_cameras_match_gsjax():
    from gsjax.data.cameras import lookat_camera as j_lookat
    from gsjax_torch.data.cameras import lookat_camera as t_lookat

    for eye, up in (((3.0, 1.0, 2.0), (0, 0, 1)), ((0.0, 0.0, 5.0), (0, 0, 1))):
        jc = j_lookat(eye, (0, 0, 0), up, 0.9, 70, 45)
        tc = t_lookat(eye, (0, 0, 0), up, 0.9, 70, 45)
        for f in ("R", "T", "fov_x", "fov_y", "width", "height"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
        jr = jc.to_render_camera()
        tr = tc.to_render_camera("cpu")
        for f in ("world_view", "full_proj", "camera_center", "tan_fov_x", "tan_fov_y"):
            got = getattr(tr, f)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jr, f)))
        assert float(tr.focal_x) == pytest.approx(float(jr.focal_x), rel=1e-6)
        assert (tr.width, tr.height) == (jr.width, jr.height)


def test_mark_visible_matches_gsjax():
    from conftest import make_test_camera
    from gsjax.ops import mark_visible as j_mark
    from gsjax_torch.data.cameras import Camera
    from gsjax_torch.ops import mark_visible as t_mark

    pts = np.random.default_rng(1).uniform(-5, 5, (300, 3)).astype(np.float32)
    cam = make_test_camera(64, 48, seed=3)
    np.testing.assert_array_equal(
        t_mark(_t(pts), Camera(uid=0, image_name="c", R=cam.R, T=cam.T, fov_x=cam.fov_x,
                               fov_y=cam.fov_y, width=64, height=48)
               .to_render_camera("cpu")).numpy(),
        np.asarray(j_mark(jnp.asarray(pts), cam.to_render_camera())))


@pytest.mark.parametrize("binary", [False, True])
def test_colmap_scene_reads_like_gsjax(tmp_path, binary):
    from gsjax.data.dataset_readers import read_colmap_scene as j_read
    from gsjax_torch.data.dataset_readers import read_colmap_scene as t_read
    from test_colmap import _write_scene

    _write_scene(str(tmp_path), binary=binary)
    j = j_read(str(tmp_path), eval_split=True)
    t = t_read(str(tmp_path), eval_split=True)
    assert t.radius == j.radius
    np.testing.assert_array_equal(t.translate, j.translate)
    np.testing.assert_array_equal(t.point_cloud.points, j.point_cloud.points)
    np.testing.assert_array_equal(t.point_cloud.colors, j.point_cloud.colors)
    for tl, jl in ((t.train_cameras, j.train_cameras), (t.test_cameras, j.test_cameras)):
        assert [c.image_name for c in tl] == [c.image_name for c in jl]
        for tc, jc in zip(tl, jl):
            np.testing.assert_array_equal(tc.R, jc.R)
            np.testing.assert_array_equal(tc.T, jc.T)
            np.testing.assert_array_equal(tc.image, jc.image)
            assert (tc.fov_x, tc.fov_y, tc.width, tc.height) == (
                jc.fov_x, jc.fov_y, jc.width, jc.height)


def test_budget_defaults_and_scene_load_branch(tmp_path):
    import dataclasses

    from gsjax.train.loop import default_rasterize_settings as j_default
    from gsjax_torch.configs import ModelParams
    from gsjax_torch.train.loop import default_rasterize_settings as t_default
    from gsjax_torch.train.scene import Scene

    for w, h, cap in ((64, 64, 4096), (1920, 1080, 1 << 20), (800, 800, 300_000)):
        js, ts = j_default(w, h, cap), t_default(w, h, cap)
        for f in dataclasses.fields(js):
            want = getattr(js, f.name)
            assert getattr(ts, f.name) == {"xla": "scan"}.get(want, want), f.name
    # no load_iteration: a fresh model from the SfM points, as gsjax's
    from gsjax.data.dataset_readers import read_colmap_scene as j_read
    from gsjax.models.gaussians import create_from_pcd as j_create
    from test_colmap import _write_scene

    src = str(tmp_path / "scene")
    _write_scene(src)
    scene = Scene(ModelParams(source_path=src, model_path=str(tmp_path / "model")),
                  device="cpu")
    assert scene.loaded_iter is None
    info = j_read(src)
    j = j_create(info.point_cloud.points, info.point_cloud.colors, info.radius)
    assert scene.gaussians.capacity == j.capacity
    assert scene.gaussians.spatial_lr_scale == j.spatial_lr_scale
    np.testing.assert_array_equal(scene.gaussians.active.numpy(), np.asarray(j.active))
    for k, v in j.params.items():
        np.testing.assert_allclose(scene.gaussians.params[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-6, err_msg=k)  # kNN: float64 vs f32 distances
