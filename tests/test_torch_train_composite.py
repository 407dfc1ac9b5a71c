"""The differentiable compositor of gsjax_torch against gsjax, on the CPU.

The training forward (``composite_fwd``'s plain version) against gsjax's
Pallas ``_composite_kernel``, the backward (``composite_grads``: the plain
per-pair gradients and the reduction to gaussians) against gsjax's
``composite_pallas_grads`` in every binning mode, at ``grad_dtype``
float32 and bfloat16 (gsjax's training default: the per-pair table
rounded to bf16, half up under ``grad_reduce="sort"``, to nearest even
under ``"gather"``), the bf16 packing helpers bit for bit against gsjax's,
the plain backward against torch autograd through the scan, and
``render()`` gradients through the kernel backend against gsjax and the
committed goldens. gsjax's Pallas kernels run in interpret mode, as its
own tests run them.
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
    _pack_bf16_pair_rows,
    _unpack_bf16_pair_word,
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
from test_torch_render import (  # noqa: F401
    GOLDENS, _golden, assert_two_tier, one_torch_thread, t_camera,
)


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
    # case: (binning kwargs, gsjax grad_reduce, active gaussians of 300, grad_dtype)
    "grid": (dict(max_pairs=1 << 14, max_tiles_per_gauss=16), "sort", 300, "float32"),
    "compact": (dict(max_pairs=1 << 14, max_tiles_per_gauss=16, expansion="compact"),
                "gather", 300, "float32"),
    "tiered": (dict(max_pairs=1 << 14, max_tiles_per_gauss=16, tier_frac=0.875),
               "sort", 300, "float32"),
    "overflow": (dict(max_pairs=256, max_tiles_per_gauss=16), "gather", 300, "float32"),
    "capacity": (dict(max_pairs=1 << 14, max_tiles_per_gauss=16), "sort", 180, "float32"),
    # gsjax's training default: per-pair gradients rounded to bf16
    "grid_bf16": (dict(max_pairs=1 << 14, max_tiles_per_gauss=16), "sort", 300, "bfloat16"),
    "tiered_bf16": (dict(max_pairs=1 << 14, max_tiles_per_gauss=16, tier_frac=0.875),
                    "sort", 300, "bfloat16"),
    "compact_bf16": (dict(max_pairs=1 << 14, max_tiles_per_gauss=16, expansion="compact"),
                     "gather", 300, "bfloat16"),
    "overflow_bf16": (dict(max_pairs=256, max_tiles_per_gauss=16), "gather", 300, "bfloat16"),
    "capacity_bf16": (dict(max_pairs=1 << 14, max_tiles_per_gauss=16), "sort", 180,
                      "bfloat16"),
}
GRAD_FIELDS = ("means2d", "conics", "colors", "opacities")


def _grad_case(case):
    """One GRAD_CASES case's inputs: gsjax's splats and bins, the port's
    kernel inputs, the port forward's final T and n_contrib (both
    backwards replay them) and seeded cotangents."""
    kw, _, n_active, _ = GRAD_CASES[case]
    width, height = 70, 45
    tx, ty = num_tiles(width, height)
    active = np.arange(300) < n_active
    js = _splats(300, 7, width, height, active=active)
    jb = jax.jit(lambda s: j_bins(s, tx, ty, **kw))(js)
    tile_start, pair_gauss, attrs = _port_inputs(js, jb)
    _, tT, tn = t_cc.composite_fwd_plain(tile_start, pair_gauss, attrs, tx, ty)
    rng = np.random.default_rng(3)
    d_colors = rng.normal(size=(tx * ty, 256, 3)).astype(np.float32)
    d_T = rng.normal(size=(tx * ty, 256)).astype(np.float32)
    port = (tile_start, pair_gauss, attrs, _t(d_colors), _t(d_T), tT, tn, tx, ty)
    return js, jb, port


def _pallas_grads(case, js, jb, port, grad_dtype, reduce):
    """gsjax's ``composite_pallas_grads`` on the case's inputs."""
    kw = GRAD_CASES[case][0]
    _, _, _, d_colors, d_T, tT, tn, tx, ty = port
    pair_attrs = pack_pair_attrs(jb.pair_gauss, js.means2d, js.conics, js.colors,
                                 js.opacities, pair_slot=jb.pair_slot)
    return composite_pallas_grads(
        pair_attrs, jb.tile_start, jnp.asarray(d_colors.numpy()), jnp.asarray(d_T.numpy()),
        jnp.asarray(tT.numpy()), jnp.asarray(tn.numpy()), jb.pair_slot,
        jb.gauss_count, jb.mt, tx, ty, grad_dtype=jnp.dtype(grad_dtype).type,
        grad_reduce=reduce, gauss_inv_perm=jb.gauss_inv_perm,
        slot_layout=slot_layout_of(kw.get("expansion", "grid")),
    )


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-6)


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_composite_grads_match_pallas_grads(case):
    _, reduce, n_active, grad_dtype = GRAD_CASES[case]
    js, jb, port = _grad_case(case)
    if case.startswith("overflow"):
        assert int(jb.num_dropped) > 0
    want = _pallas_grads(case, js, jb, port, grad_dtype, reduce)
    before = t_cc.composite_bwd.launches
    got = t_cc.composite_grads(*port, grad_dtype=grad_dtype, grad_reduce=reduce)
    assert t_cc.composite_bwd.launches == before
    for name, g, w in zip(GRAD_FIELDS, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        assert float(np.abs(np.asarray(w)).max()) > 0, name
        _norm_close(g.numpy(), w, f"{case} d_{name}")
    if n_active < 300:
        assert not any(g[n_active:].any() for g in got)


@pytest.mark.parametrize("case", ["grid_bf16", "compact_bf16"])
def test_float32_grads_miss_gsjax_s_bf16_grads(case):
    """The fault that grad_dtype repairs: on the same inputs, gsjax's bf16
    gradients are 1e-3 to 3e-3 (normalised) away from float32 ones — past
    the 5e-4 rule of the tests above — so a port that ignores grad_dtype
    misses gsjax's training step, and one that honours it lands within."""
    _, reduce, _, _ = GRAD_CASES[case]
    js, jb, port = _grad_case(case)
    want = _pallas_grads(case, js, jb, port, "bfloat16", reduce)
    f32 = t_cc.composite_grads(*port, grad_dtype="float32", grad_reduce=reduce)
    bf16 = t_cc.composite_grads(*port, grad_dtype="bfloat16", grad_reduce=reduce)
    for name, a, b, w in zip(GRAD_FIELDS, f32, bf16, want):
        assert _norm_err(a.numpy(), w) > 5e-4, name
        assert _norm_err(b.numpy(), w) <= 5e-4, name


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
    _render_grads_against_pallas(dict(max_pairs=1 << 14, expansion="compact"))


@pytest.mark.parametrize("reduce", ["sort", "gather"])
def test_render_gradients_kernel_backend_match_pallas_bf16(reduce):
    """gsjax's training default, bf16 per-pair gradients, through render()."""
    _render_grads_against_pallas(dict(max_pairs=1 << 14, expansion="compact",
                                      grad_dtype="bfloat16", grad_reduce=reduce))


def test_scan_backend_ignores_grad_dtype():
    """The scan backend, as gsjax's "xla" one, differentiates the scan at
    float32 whatever grad_dtype and grad_reduce say: its gradients bit for
    bit. (A tile holds at most the 120 gaussians, so the scan's depth of
    128 caps nothing.)"""
    gs = make_test_gaussians(120, np.random.default_rng(8))
    cam = t_camera(make_test_camera(48, 32, seed=3))
    bg = np.zeros(3, np.float32)
    wimg = np.random.default_rng(9).normal(size=(32, 48, 3)).astype(np.float32)
    f32, *bf16 = [_t_render_grads(cam, gs, bg, wimg, TSettings(
        max_pairs=1 << 13, max_splats_per_tile=128, backend="scan", grad_dtype=dt,
        grad_reduce=reduce))
        for dt, reduce in (("float32", "sort"), ("bfloat16", "sort"), ("bfloat16", "gather"))]
    for other in bf16:
        for name, a, b in zip(GRAD_NAMES, f32, other):
            assert float(np.abs(a).max()) > 0, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def _render_grads_against_pallas(kw):
    gs = make_test_gaussians(200, np.random.default_rng(5))
    cam = make_test_camera(64, 48, seed=2)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    wimg = np.random.default_rng(7).normal(size=(48, 64, 3)).astype(np.float32)
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


# --------------------------------------------------------------------------
# (e) the bf16 packing, bit for bit against gsjax's
# --------------------------------------------------------------------------

# float32 bit patterns: +-0, exact ties (low half 0x8000) on even and odd
# mantissas and their negatives, subnormals (the smallest, the largest, a
# tie), the largest finite value (rounds to inf) and +-inf, values just
# below and above a tie, and a carry into the exponent
EDGE_BITS = np.array([
    0x00000000, 0x80000000, 0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,
    0x00000001, 0x007FFFFF, 0x807FFFFF, 0x00008000, 0x00018000, 0x7F7FFFFF,
    0xFF7FFFFF, 0x7F800000, 0xFF800000, 0x3F807FFF, 0x3F808001, 0x3F80FFFF,
    0x7F7F8000, 0x00400000, 0x4049FFFF, 0xC049FFFF,
], np.uint32)


def _edge_table():
    """EDGE_BITS and 240 seeded values over float32's whole range, as a
    (P, 9) float32 table."""
    rng = np.random.default_rng(0)
    wide = rng.normal(size=240) * 10.0 ** rng.integers(-44, 38, 240)
    vals = np.concatenate([EDGE_BITS.view(np.float32),
                           np.clip(wide, -3e38, 3e38).astype(np.float32)])
    vals = np.concatenate([vals, np.zeros(-vals.size % 9, np.float32)])
    return vals.reshape(-1, 9)


def _gsjax_words(table, round_fn):
    """gsjax's packed words of a (P, 9) table: column pairs (0, 1) ... (8, zero)."""
    cols = [jnp.asarray(c) for c in table.T] + [jnp.zeros(table.shape[0], jnp.float32)]
    return np.stack([np.asarray(round_fn(cols[2 * w], cols[2 * w + 1])).view(np.int32)
                     for w in range(5)], 1)


def _astype_bf16_pair(a, b):
    """gsjax's "gather" rounding, ``.astype(bfloat16)``, packed as the port packs it."""
    hi, lo = (np.asarray(x.astype(jnp.bfloat16)).view(np.uint16).astype(np.uint32)
              for x in (a, b))
    return (hi << 16 | lo).view(np.float32)


@pytest.mark.parametrize("half_up", [True, False], ids=["half_up", "nearest_even"])
def test_pack_bf16_pairs_rounds_as_gsjax(half_up):
    """Half up: gsjax's ``_pack_bf16_pair_rows`` bit for bit; to nearest
    even: ``.astype(jnp.bfloat16)`` bit for bit, NaNs of either sign too."""
    table = _edge_table()
    if not half_up:  # quiet and signalling NaNs of both signs
        nans = np.array([0x7FC00000, 0x7F800001, 0xFFC00001, 0x7FFFFFFF], np.uint32)
        table = np.concatenate([table, np.zeros((1, 9), np.float32)])
        table[-1, :4] = nans.view(np.float32)
    got = t_cc.pack_bf16_pairs(torch.from_numpy(table), half_up=half_up)
    assert got.dtype == torch.int32 and got.shape == (table.shape[0], 5)
    want = _gsjax_words(table, _pack_bf16_pair_rows if half_up else _astype_bf16_pair)
    np.testing.assert_array_equal(got.numpy(), want)
    # the two rules part on ties only: an even mantissa stays, an odd one rounds up
    ties = t_cc.pack_bf16_pairs(torch.from_numpy(
        EDGE_BITS[[2, 3, 4, 5]].view(np.float32).repeat(3)[:9][None]), half_up=half_up)
    hi = (ties[0, 0].item() >> 16) & 0xFFFF
    assert hi == (0x3F81 if half_up else 0x3F80)


def test_unpack_bf16_pairs_is_gsjax_s_unpack():
    """``unpack_bf16_pairs`` against ``_unpack_bf16_pair_word`` bit for bit
    (subnormals, infs and NaNs widened exactly), and packing the result
    again changes nothing under either rounding."""
    table = _edge_table()
    words = t_cc.pack_bf16_pairs(torch.from_numpy(table), half_up=True)
    words = torch.cat([words, torch.tensor([[0x7FC0FFC1, -1, 0x00010001, 0x7F807F80,
                                             -(1 << 31)]], dtype=torch.int32)])
    got = t_cc.unpack_bf16_pairs(words)
    assert got.dtype == torch.float32 and got.shape == (words.shape[0], 9)
    want = []
    for w in range(5):
        want += [np.asarray(x) for x in _unpack_bf16_pair_word(jnp.asarray(words[:, w].numpy()))]
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.stack(want[:9], 1).view(np.uint32))
    finite = words[:-1]  # no NaN: the rounding of a widened bf16 is itself
    for half_up in (True, False):
        assert torch.equal(t_cc.pack_bf16_pairs(t_cc.unpack_bf16_pairs(finite), half_up),
                           finite)


def test_grad_settings_are_checked():
    """Invalid grad_dtype / grad_reduce raise, in the settings and in the
    wrappers; the CPU's bf16 table is (P, 5) int32, its float32 table
    packed."""
    with pytest.raises(ValueError, match="grad_dtype"):
        TSettings(grad_dtype="float16")
    with pytest.raises(ValueError, match="grad_reduce"):
        TSettings(grad_reduce="scatter")
    js, jb, port = _grad_case("compact")
    for bad in (dict(grad_dtype="bf16"), dict(grad_reduce="segment")):
        for fn in (t_cc.composite_bwd, t_cc.composite_bwd_plain, t_cc.composite_grads):
            with pytest.raises(ValueError, match=next(iter(bad))):
                fn(*port, **bad)
    f32 = t_cc.composite_bwd(*port)
    assert f32.dtype == torch.float32 and f32.shape == (port[1].shape[0], 9)
    for reduce, half_up in (("sort", True), ("gather", False)):
        table, counts = t_cc.composite_bwd_counts(*port, grad_dtype="bfloat16",
                                                  grad_reduce=reduce)
        assert table.dtype == torch.int32 and table.shape == (port[1].shape[0], 5)
        assert torch.equal(table, t_cc.pack_bf16_pairs(f32, half_up=half_up))
        assert counts.dtype == torch.int32 and int(counts.sum()) > 0
