"""The differentiable compositor of gsjax_torch against gsjax, on the CPU.

The training forward (``composite_fwd``'s plain version) against gsjax's
Pallas ``_composite_kernel``, the backward (``composite_grads``: the plain
per-pair gradients and the reduction to gaussians) against gsjax's
``composite_pallas_grads`` in every binning mode, the plain backward
against torch autograd through the scan, and ``render()`` gradients through
the kernel backend against gsjax and the committed goldens. gsjax's Pallas
kernels run in interpret mode, as its own tests run them.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_camera, make_test_gaussians
from gsjax.ops import RasterizeSettings as JSettings
from gsjax.ops import render as j_render
from gsjax.ops.binning import build_tile_bins as j_bins
from gsjax.ops.binning import slot_layout_of
from gsjax.ops.pallas_composite import (
    composite_pallas_grads,
    composite_tiles_pallas,
    pack_pair_attrs,
)
from gsjax.ops.projection import Splats as JSplats
from gsjax.ops.projection import num_tiles
from gsjax.ops.projection import preprocess as j_preprocess
from gsjax_torch.ops import RasterizeSettings as TSettings
from gsjax_torch.ops import cuda_composite as t_cc
from gsjax_torch.ops import render as t_render
from gsjax_torch.ops.composite import composite_tiles
from test_torch_render import GOLDENS, _golden, assert_two_tier, t_camera


def _t(x):
    return torch.from_numpy(np.array(x))


def _norm_close(got, want, name, atol=5e-4):
    """|got - want| / max|want| <= atol (the rule of tests/test_render.py's
    Pallas-vs-XLA gradient check)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert np.isfinite(got).all(), name
    err = float(np.abs(got - want).max()) / scale
    assert err <= atol, (name, err)


def _splats(n, seed, width, height, dense=False, active=None):
    """gsjax preprocess of a seeded scene, as jnp arrays."""
    kw = dict(spread=0.6, z_range=(3.0, 4.0)) if dense else {}
    gs = make_test_gaussians(n, np.random.default_rng(seed), **kw)
    if dense:
        gs[3][:] = np.random.default_rng(seed).uniform(0.6, 0.99, n)
    cam = make_test_camera(width, height, seed=1).to_render_camera()
    act = None if active is None else jnp.asarray(active)
    return jax.jit(lambda *a: j_preprocess(*a, cam, 3, active_mask=act))(
        *map(jnp.asarray, gs))


def _port_inputs(js, jb):
    """The port's kernel inputs from gsjax's splats and bins."""
    attrs = t_cc.pack_gauss_attrs(*(_t(x) for x in (
        js.means2d, js.conics, js.colors, js.opacities)))
    return _t(jb.tile_start), _t(jb.pair_gauss), attrs


# --------------------------------------------------------------------------
# (a) the training forward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
def test_composite_fwd_plain_matches_pallas_forward(dense):
    tx, ty = num_tiles(64, 64)
    js = _splats(250, 4, 64, 64, dense=dense)
    jb = jax.jit(lambda s: j_bins(s, tx, ty, 1 << 14, max_tiles_per_gauss=16))(js)
    pair_attrs = pack_pair_attrs(jb.pair_gauss, js.means2d, js.conics, js.colors,
                                 js.opacities)
    jc, jT, jn = composite_tiles_pallas(pair_attrs, jb.tile_start, tx, ty)

    tile_start, pair_gauss, attrs = _port_inputs(js, jb)
    before = t_cc.composite_fwd.launches
    tc, tT, tn = t_cc.composite_fwd(tile_start, pair_gauss, attrs, tx, ty)
    assert t_cc.composite_fwd.launches == before  # CPU tensors: the plain version
    assert tn.dtype == torch.int32 and tn.shape == (tx * ty, 256)
    assert_two_tier(tc.numpy(), jc, "tile_colors")
    assert_two_tier(tT.numpy(), jT, "tile_T")
    assert (tn.numpy() == np.asarray(jn)).mean() >= 0.999
    assert int(tn.max()) > 0
    # the inference path's image is the same scan without the bookkeeping
    ic, iT = t_cc.composite_infer_plain(tile_start, pair_gauss, attrs, tx, ty)
    assert torch.equal(ic, tc) and torch.equal(iT, tT)
    if dense:
        assert float(tT.min()) < 1e-3  # the early exit runs


# --------------------------------------------------------------------------
# (b) per-gaussian gradients against composite_pallas_grads
# --------------------------------------------------------------------------

GRAD_CASES = {
    # case: (binning kwargs, gsjax grad_reduce, active gaussians of 300)
    "grid": (dict(max_pairs=1 << 14, max_tiles_per_gauss=16), "sort", 300),
    "compact": (dict(max_pairs=1 << 14, max_tiles_per_gauss=16, expansion="compact"),
                "gather", 300),
    "tiered": (dict(max_pairs=1 << 14, max_tiles_per_gauss=16, tier_frac=0.875),
               "sort", 300),
    "overflow": (dict(max_pairs=256, max_tiles_per_gauss=16), "gather", 300),
    "capacity": (dict(max_pairs=1 << 14, max_tiles_per_gauss=16), "sort", 180),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_composite_grads_match_pallas_grads(case):
    kw, reduce, n_active = GRAD_CASES[case]
    width, height = 70, 45
    tx, ty = num_tiles(width, height)
    active = np.arange(300) < n_active
    js = _splats(300, 7, width, height, active=active)
    jb = jax.jit(lambda s: j_bins(s, tx, ty, **kw))(js)
    if case == "overflow":
        assert int(jb.num_dropped) > 0
    tile_start, pair_gauss, attrs = _port_inputs(js, jb)
    # both backwards replay the port's forward: same final T and n_contrib
    _, tT, tn = t_cc.composite_fwd_plain(tile_start, pair_gauss, attrs, tx, ty)
    rng = np.random.default_rng(3)
    d_colors = rng.normal(size=(tx * ty, 256, 3)).astype(np.float32)
    d_T = rng.normal(size=(tx * ty, 256)).astype(np.float32)

    pair_attrs = pack_pair_attrs(jb.pair_gauss, js.means2d, js.conics, js.colors,
                                 js.opacities, pair_slot=jb.pair_slot)
    want = composite_pallas_grads(
        pair_attrs, jb.tile_start, jnp.asarray(d_colors), jnp.asarray(d_T),
        jnp.asarray(tT.numpy()), jnp.asarray(tn.numpy()), jb.pair_slot,
        jb.gauss_count, jb.mt, tx, ty, grad_dtype=jnp.float32, grad_reduce=reduce,
        gauss_inv_perm=jb.gauss_inv_perm,
        slot_layout=slot_layout_of(kw.get("expansion", "grid")),
    )
    before = t_cc.composite_bwd.launches
    got = t_cc.composite_grads(tile_start, pair_gauss, attrs, _t(d_colors), _t(d_T),
                               tT, tn, tx, ty)
    assert t_cc.composite_bwd.launches == before
    for name, g, w in zip(("means2d", "conics", "colors", "opacities"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        assert float(np.abs(np.asarray(w)).max()) > 0, name
        _norm_close(g.numpy(), w, f"{case} d_{name}")
    if n_active < 300:
        assert not any(g[n_active:].any() for g in got)


def test_reduce_pair_grads_drops_nothing_and_orders_nothing():
    """Rows past tile_start[-1] are ignored; each gaussian gets the sum of
    its rows whatever their order."""
    rng = np.random.default_rng(0)
    pg = torch.from_numpy(rng.integers(0, 6, 40).astype(np.int32))
    grads = torch.from_numpy(rng.normal(size=(40, 9)).astype(np.float32))
    tile_start = torch.tensor([0, 10, 30], dtype=torch.int32)
    out = t_cc.reduce_pair_grads(grads, pg, tile_start, 8)
    want = torch.zeros(8, 9, dtype=torch.float64)
    want.index_add_(0, pg[:30].long(), grads[:30].double())
    assert out.shape == (8, 9)
    torch.testing.assert_close(out.double(), want, rtol=1e-6, atol=1e-6)
    empty = t_cc.reduce_pair_grads(grads, pg, torch.zeros(3, dtype=torch.int32), 8)
    assert not empty.any()


# --------------------------------------------------------------------------
# (c) the plain backward against torch autograd through the scan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
def test_composite_bwd_plain_matches_autograd_through_scan(dense):
    tx, ty = num_tiles(64, 48)
    js = _splats(200, 11, 64, 48, dense=dense)
    jb = jax.jit(lambda s: j_bins(s, tx, ty, 1 << 14, max_tiles_per_gauss=16,
                                  expansion="compact"))(js)
    tile_start, pair_gauss = _t(jb.tile_start), _t(jb.pair_gauss)
    blend = [_t(x).requires_grad_(True) for x in (
        js.means2d, js.conics, js.colors, js.opacities)]
    rng = np.random.default_rng(1)
    d_colors = _t(rng.normal(size=(tx * ty, 256, 3)).astype(np.float32))
    d_T = _t(rng.normal(size=(tx * ty, 256)).astype(np.float32))

    sc, sT, _ = composite_tiles(pair_gauss, tile_start, *blend, tx, ty, 1024, 32)
    want = torch.autograd.grad((sc * d_colors).sum() + (sT * d_T).sum(), blend)
    kc, kT = t_cc.composite(*blend, tile_start, pair_gauss, tx, ty)
    torch.testing.assert_close(kc, sc, rtol=0, atol=0)  # the same scan
    got = torch.autograd.grad((kc * d_colors).sum() + (kT * d_T).sum(), blend)
    for name, g, w in zip(("means2d", "conics", "colors", "opacities"), got, want):
        _norm_close(g.numpy(), w.numpy(), name, atol=1e-5)


# --------------------------------------------------------------------------
# (d) render() gradients through the kernel backend
# --------------------------------------------------------------------------

GRAD_NAMES = ("means3d", "scales", "quats", "opacities", "shs", "means2d")


def _t_render_grads(rcam, gs, bg, wimg, settings):
    args = [_t(a).requires_grad_(True) for a in gs]
    offset = torch.zeros((gs[0].shape[0], 2), requires_grad=True)
    out = t_render(rcam, *args, 3, _t(bg), settings, means2d_offset=offset)
    loss = (out["render"] * _t(wimg)).sum()
    assert int(out["num_dropped"]) == 0
    return [g.numpy() for g in torch.autograd.grad(loss, args + [offset])]


@pytest.mark.parametrize("path", GOLDENS, ids=os.path.basename)
def test_render_gradients_kernel_backend_match_goldens(path):
    z, cam, gs = _golden(path)
    s = TSettings(max_pairs=1 << 17, max_splats_per_tile=1024, chunk=32, backend="kernel")
    grads = _t_render_grads(t_camera(cam), gs, z["bg"], z["wimg"], s)
    # the tolerance tests/test_goldens.py holds gsjax's tile pipeline to
    for g, name in zip(grads, GRAD_NAMES):
        ref = z[f"g_{name}"]
        np.testing.assert_allclose(
            g, ref, rtol=float(z["tol_grad_rel"]),
            atol=2e-3 * max(float(np.abs(ref).max()), 1.0), err_msg=name)


def test_render_gradients_kernel_backend_match_pallas():
    gs = make_test_gaussians(200, np.random.default_rng(5))
    cam = make_test_camera(64, 48, seed=2)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    wimg = np.random.default_rng(7).normal(size=(48, 64, 3)).astype(np.float32)
    kw = dict(max_pairs=1 << 14, expansion="compact")
    rc = cam.to_render_camera()

    def j_loss(args):
        out = j_render(rc, *args[:5], 3, jnp.asarray(bg),
                       JSettings(backend="pallas", **kw), means2d_offset=args[5])
        return jnp.sum(out["render"] * wimg)

    jargs = tuple(map(jnp.asarray, gs)) + (jnp.zeros((200, 2), jnp.float32),)
    want = jax.jit(jax.grad(j_loss))(jargs)
    got = _t_render_grads(t_camera(cam), gs, bg, wimg, TSettings(backend="kernel", **kw))
    for name, g, w in zip(GRAD_NAMES, got, want):
        _norm_close(g, w, name)
