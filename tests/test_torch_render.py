"""gsjax_torch's render path against gsjax end to end, on the CPU: the
rasterizer, the committed goldens, edge cases and f16 overflow
(``tests/test_torch_render_io.py``: the weight carry-over from a gsjax
state, PLY interchange, the budget probe and the offline-render CLI)."""

import dataclasses
import glob
import os
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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work here is many small tensor ops: one intra-op
    thread each, so that the test workers running side by side do not
    oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
