"""gsjax_torch ops against gsjax, module by module, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function and
its port. gsjax runs as its own tests run it: JAX on the CPU, Pallas
kernels in interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_camera, make_test_gaussians
from gsjax.ops.binning import build_tile_bins as j_bins
from gsjax.ops.composite import composite_tiles as j_composite_tiles
from gsjax.ops.pallas_composite import composite_tiles_pallas, pack_pair_attrs
from gsjax.ops.projection import Splats as JSplats
from gsjax.ops.projection import num_tiles
from gsjax.ops.projection import preprocess as j_preprocess
from gsjax_torch.data.cameras import Camera as TCamera
from gsjax_torch.ops import binning as t_binning
from gsjax_torch.ops import composite as t_composite
from gsjax_torch.ops import cuda_composite as t_cc
from gsjax_torch.ops.projection import Splats as TSplats
from gsjax_torch.ops.projection import preprocess as t_preprocess
from gsjax_torch.utils.profiling import launches

FLOAT_FIELDS = ("means2d", "depths", "conics")
INT_FIELDS = ("radii", "rect_min", "rect_max", "tiles_touched")


def t_camera(cam):
    """The port's camera for a gsjax ``Camera`` (same pose and intrinsics)."""
    return TCamera(uid=cam.uid, image_name=cam.image_name, R=cam.R, T=cam.T,
                   fov_x=cam.fov_x, fov_y=cam.fov_y, width=cam.width,
                   height=cam.height).to_render_camera("cpu")


def scene(n, seed, width, height, cam_seed=None, **kw):
    gs = make_test_gaussians(n, np.random.default_rng(seed), **kw)
    return gs, make_test_camera(width, height, seed=cam_seed)


@functools.lru_cache(maxsize=None)
def _j_preprocess_fn(width, height, opacity_aware_radius):
    def f(rcam, *a, active_mask, scale_modifier):
        return j_preprocess(*a, rcam, 3, active_mask=active_mask,
                            scale_modifier=scale_modifier,
                            opacity_aware_radius=opacity_aware_radius)
    return jax.jit(f)


def both_preprocess(gs, cam, active=None, scale_modifier=1.0,
                    opacity_aware_radius=True):
    jf = _j_preprocess_fn(cam.width, cam.height, opacity_aware_radius)
    j = jf(cam.to_render_camera(), *map(jnp.asarray, gs),
           active_mask=None if active is None else jnp.asarray(active),
           scale_modifier=scale_modifier)
    t = t_preprocess(*map(torch.from_numpy, gs), t_camera(cam), 3,
                     active_mask=None if active is None else torch.from_numpy(active),
                     scale_modifier=scale_modifier,
                     opacity_aware_radius=opacity_aware_radius)
    return JSplats(*(np.array(x) for x in j)), t


def assert_f16_ulp(got, want, name):
    """Within one f16 ulp of the reference value: both sides round an f32
    value to f16, and the f32 inputs differ in their last bits (XLA and
    torch evaluate exp/sqrt/sums with different roundings), which can flip
    the f16 rounding of a value sitting at a half-ulp boundary."""
    got, want = np.asarray(got), np.asarray(want)
    ulp = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), (name, got[bad][:5], want[bad][:5])


@pytest.mark.parametrize(
    "width,height,case",
    [(64, 64, "plain"), (80, 48, "active_scaled"), (70, 45, "no_opacity_radius")],
)
def test_preprocess_matches_gsjax(width, height, case):
    gs, cam = scene(300, 1, width, height, cam_seed=5)
    kw = {}
    if case == "active_scaled":
        kw = dict(active=np.random.default_rng(2).random(300) < 0.7,
                  scale_modifier=0.8)
    if case == "no_opacity_radius":
        kw = dict(opacity_aware_radius=False)
    j, t = both_preprocess(gs, cam, **kw)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), getattr(j, f), err_msg=f)
        assert getattr(t, f).dtype == torch.int32
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(t, f).numpy(), getattr(j, f),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    assert_f16_ulp(t.colors.numpy(), j.colors, "colors")
    assert_f16_ulp(t.opacities.numpy(), j.opacities, "opacities")
    assert (j.tiles_touched > 0).sum() > 50  # the scene is on screen


def test_quantize_and_f16_pack_contract():
    """The port's f16 rounding and pack/decode reproduce gsjax's bits."""
    from gsjax.ops.pallas_composite import pack_f16_pair as j_pack
    from gsjax.ops.projection import quantize_f16 as j_q
    from gsjax_torch.ops.projection import quantize_f16 as t_q

    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(0, 2, 500), rng.uniform(0, 1e-4, 100),
                        [0.0, 1.0, 0.5, 2.0 ** -14, 65504.0, 7e4]]).astype(np.float32)
    y = rng.uniform(0, 1, x.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(t_q(torch.from_numpy(x)).numpy(), np.asarray(j_q(jnp.asarray(x))))
    tw = t_cc.pack_f16_pair(torch.from_numpy(x), torch.from_numpy(y))
    jw = j_pack(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(tw.view(torch.int32).numpy(),
                                  np.asarray(jw).view(np.int32))
    attrs = t_cc.pack_gauss_attrs(torch.zeros(len(x), 2), torch.zeros(len(x), 3),
                                  torch.from_numpy(np.stack([x, y, x], 1)),
                                  torch.from_numpy(y))
    _, _, col, op = t_cc.unpack_gauss_attrs(attrs)
    q = t_q(torch.from_numpy(x))
    np.testing.assert_array_equal(col[:-1, 0].numpy(), q[:-1].numpy())
    np.testing.assert_array_equal(op.numpy(), t_q(torch.from_numpy(y)).numpy())
    # 7e4 overflows f16 (quantize_f16 gives inf); the decode reads the inf
    # pattern as gsjax's Pallas kernels do (_f16_pair_rows): 65536
    assert np.isinf(q[-1].item()) and col[-1, 0].item() == 65536.0
    from gsjax.ops.pallas_composite import _f16_pair_rows

    hi, lo = t_cc.decode_f16_pair(tw)
    j_hi, j_lo = _f16_pair_rows(jw)
    np.testing.assert_array_equal(hi.view(torch.int32).numpy(), np.asarray(j_hi).view(np.int32))
    np.testing.assert_array_equal(lo.view(torch.int32).numpy(), np.asarray(j_lo).view(np.int32))


# --------------------------------------------------------------------------
# binning: gsjax's own Splats into both packages -> bit-identical outputs
# --------------------------------------------------------------------------


def _to_torch_splats(js):
    return TSplats(*(torch.from_numpy(np.array(x)) for x in js))


def _bins_both(js, tiles_x, tiles_y, **kw):
    max_pairs = kw.pop("max_pairs")
    jb = jax.jit(lambda s: j_bins(s, tiles_x, tiles_y, max_pairs, **kw))(
        JSplats(*map(jnp.asarray, js)))
    tb = t_binning.build_tile_bins(_to_torch_splats(js), tiles_x, tiles_y,
                                   max_pairs, **kw)
    return jb, tb


BIN_FIELDS = ("pair_gauss", "pair_tile", "pair_slot", "tile_start", "num_pairs",
              "num_dropped", "num_mt_capped", "num_tier_capped", "gauss_count",
              "gauss_inv_perm")

BIN_CASES = {
    "exact": dict(exact_depth_sort=True, max_tiles_per_gauss=16),
    "compact": dict(expansion="compact", max_tiles_per_gauss=16),
    "grid": dict(max_tiles_per_gauss=16),
    "tiered": dict(max_tiles_per_gauss=16, tier_frac=0.875),
    "compact_budget_drop": dict(expansion="compact", max_tiles_per_gauss=16,
                                max_pairs=700),
    "grid_budget_drop": dict(max_tiles_per_gauss=8, max_pairs=640),
    "tiered_tier_cap": dict(max_tiles_per_gauss=16, tier_frac=0.875),
    "compact_mt_cap": dict(expansion="compact", max_tiles_per_gauss=4),
    # n * (mt + 1) >= 2**31: gsjax's two-key partition-sort branch
    "compact_wide_mt": dict(expansion="compact", max_tiles_per_gauss=1 << 22,
                            max_pairs=4096),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_binning_bit_identical(case):
    kw = dict(BIN_CASES[case])
    kw.setdefault("max_pairs", 1 << 13)
    gs, cam = scene(300, 3, 80, 48, cam_seed=2)
    if case in ("compact_mt_cap", "compact_wide_mt", "grid_budget_drop"):
        gs[1][:6] *= 6.0  # a few wide gaussians: they hit the mt cap
    if case == "tiered_tier_cap":
        # more wide gaussians than the big tier's 300 - 256 rows
        gs[1][:80] *= 4.0
    js, _ = both_preprocess(gs, cam)
    if not kw.get("exact_depth_sort"):
        # -0.0 depths on visible gaussians: gsjax's maximum(d, 0) maps them
        # to +0.0 before taking the bit pattern; the port must too
        vis = np.flatnonzero(js.tiles_touched > 0)[:3]
        js.depths[vis[:2]] = -0.0
        js.depths[vis[2]] = 0.0
    tiles_x, tiles_y = num_tiles(cam.width, cam.height)
    jb, tb = _bins_both(js, tiles_x, tiles_y, **kw)
    for f in BIN_FIELDS:
        jv, tv = getattr(jb, f), getattr(tb, f)
        if jv is None:
            assert tv is None, f
            continue
        assert tv.dtype == torch.int32, f
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=f)
    assert tb.mt == jb.mt
    if "drop" in case:
        assert int(tb.num_dropped) > int(tb.num_mt_capped) >= 0
    if case in ("tiered_tier_cap",):
        assert int(tb.num_tier_capped) > 0
    if case in ("compact_mt_cap",):
        assert int(tb.num_mt_capped) > 0


def test_slot_layout_of():
    for expansion in ("grid", "compact"):
        for eds in (False, True):
            from gsjax.ops.binning import slot_layout_of as j

            assert t_binning.slot_layout_of(expansion, eds) == j(expansion, eds)


# --------------------------------------------------------------------------
# compositing
# --------------------------------------------------------------------------


def _pipeline_inputs(n, seed, width, height, dense=False, max_pairs=1 << 14):
    """gsjax preprocess + binning for one scene, as numpy."""
    kw = dict(spread=0.6, z_range=(3.0, 4.0)) if dense else {}
    gs, cam = scene(n, seed, width, height, cam_seed=1, **kw)
    if dense:
        gs[3][:] = np.random.default_rng(seed).uniform(0.6, 0.99, n)
    js, _ = both_preprocess(gs, cam)
    tx, ty = num_tiles(width, height)
    jb = jax.jit(lambda s: j_bins(s, tx, ty, max_pairs, max_tiles_per_gauss=16))(
        JSplats(*map(jnp.asarray, js)))
    return js, jb, tx, ty


def assert_two_tier(got, want, name, tol=1e-4):
    """max |diff| <= ``tol``; where a pair sits on the 1/255 alpha cut or the
    1e-4 transmittance exit, one implementation can take it and the other
    not (the last-ulp exp / product difference), moving a few pixels by up
    to about one minimum contribution — the two-tier rule of bench.py:
    at most 0.1% of the values past ``tol`` and none past 6e-3."""
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert np.isfinite(d).all(), name
    past = d > tol
    assert past.mean() <= 1e-3 and d.max() <= 6e-3, (name, d.max(), past.sum())


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
def test_kernel_plain_version_matches_pallas_infer(dense):
    js, jb, tx, ty = _pipeline_inputs(250, 4, 64, 64, dense=dense)
    pair_attrs = pack_pair_attrs(jb.pair_gauss, *map(jnp.asarray, (
        js.means2d, js.conics, js.colors, js.opacities)))
    jc, jT, _ = composite_tiles_pallas(pair_attrs, jb.tile_start, tx, ty, infer=True)

    attrs = t_cc.pack_gauss_attrs(*(torch.from_numpy(np.array(x)) for x in (
        js.means2d, js.conics, js.colors, js.opacities)))
    # the port's per-gaussian rows, gathered through pair_gauss, are gsjax's
    # pair-table rows 0..6 bit for bit
    p = jb.pair_gauss.shape[0]
    j_rows = np.asarray(pair_attrs).transpose(0, 2, 1).reshape(-1, 8)[:p, :7]
    t_rows = attrs[torch.from_numpy(np.array(jb.pair_gauss)).long(), :7]
    np.testing.assert_array_equal(t_rows.numpy().view(np.int32), j_rows.view(np.int32))

    tile_start = torch.from_numpy(np.array(jb.tile_start))
    pair_gauss = torch.from_numpy(np.array(jb.pair_gauss))
    tc, tT, n_eval = t_cc.composite_infer_plain(tile_start, pair_gauss, attrs, tx, ty,
                                                return_evals=True)
    assert_two_tier(tc.numpy(), jc, "tile_colors")
    assert_two_tier(tT.numpy(), jT, "tile_T")
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = launches()
    wc, wT = t_cc.composite_infer(tile_start, pair_gauss, attrs, tx, ty)
    assert launches() == before
    torch.testing.assert_close(wc, tc, rtol=0, atol=0)
    counts = (tile_start[1:] - tile_start[:-1]).long()
    assert int(n_eval.sum()) <= 256 * int(counts.sum())
    if dense:
        # saturated pixels stop early: the walk needs fewer evaluations
        assert float(tT.min()) < 1e-3
        assert int(n_eval.sum()) < 256 * int(counts.sum())


def test_composite_tiles_matches_gsjax_with_cap():
    js, jb, tx, ty = _pipeline_inputs(300, 6, 80, 48, dense=True)
    args = (js.means2d, js.conics, js.colors, js.opacities)
    for cap in (32, 1024):  # 32 truncates the deep tiles: num_tile_capped > 0
        jc, jT, jcap = jax.jit(lambda *a: j_composite_tiles(
            jb.pair_gauss, jb.tile_start, *a, tx, ty, cap, 32))(*map(jnp.asarray, args))
        tc, tT, tcap = t_composite.composite_tiles(
            torch.from_numpy(np.array(jb.pair_gauss)),
            torch.from_numpy(np.array(jb.tile_start)),
            *(torch.from_numpy(np.array(a)) for a in args), tx, ty, cap, 32)
        assert int(tcap) == int(jcap)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
        np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=2e-5)
        if cap == 32:
            assert int(tcap) > 0


def test_assemble_image_matches_gsjax():
    from gsjax.ops.composite import assemble_image as j_asm

    rng = np.random.default_rng(0)
    tx, ty = num_tiles(70, 45)
    tc = rng.random((tx * ty, 256, 3)).astype(np.float32)
    tT = rng.random((tx * ty, 256)).astype(np.float32)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    ji, jt = j_asm(jnp.asarray(tc), jnp.asarray(tT), jnp.asarray(bg), tx, ty, 70, 45)
    ti, tt = t_composite.assemble_image(torch.from_numpy(tc), torch.from_numpy(tT),
                                        torch.from_numpy(bg), tx, ty, 70, 45)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))

