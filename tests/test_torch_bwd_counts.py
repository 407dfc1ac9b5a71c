"""The backward kernel's work counts, on the CPU.

``composite_bwd_plain(..., return_evals=True)`` reports the per-pixel
count of contributing (pair, pixel) evaluations and the kernel's
warp-level work: (pair, warp) steps under the tile's and under the warp's
replay bound and after the per-warp cull, steps with a contributing lane,
warp reduce-scatters, and the per-tile largest ``n_contrib``. Each is held
against a direct numpy count (``test_torch_cuda.direct_counts``) on a
small sparse and a small saturating scene and on a frame of the cull
sweep's gaussians. The card tests run the kernel's check instances against
the same counts; here it is also shown that a cull to each gaussian's
3-sigma box would fail that check. Imports no JAX:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_bwd_counts.py
"""

import numpy as np
import pytest
import torch

from gsjax_torch.ops import cuda_composite as cc
from gsjax_torch.utils.profiling import launches
from test_torch_cuda import (
    _bwd_inputs, _cuda, _inputs, _scene, assert_cull_loses_nothing, count_rule_fails,
    direct_counts,
)

CASES = {"sparse": (False, (70, 45)), "saturating": (True, (70, 45)),
         "sparse_square": (False, (64, 64))}


def _case(name):
    dense, size = CASES[name]
    with torch.no_grad():
        return _bwd_inputs(_inputs(_scene(300, 4, dense), *size, "cpu"))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_counts_match_direct_count(name):
    bwd = _case(name)
    _, n_live, stats = cc.composite_bwd_plain(*bwd, return_evals=True)
    d_live, _, want = direct_counts(*bwd[:3], bwd[6], bwd[7], bwd[8])
    assert int(n_live.sum()) > 0
    # the same float32 expressions: the same set, pixel for pixel
    assert np.array_equal(n_live.numpy(), d_live)
    assert np.array_equal(stats["maxn"].numpy(), want["maxn"])
    for key in ("steps_tile_bound", "steps_warp_bound", "steps_walked", "steps_contrib",
                "reductions"):
        assert stats[key] == want[key], key
    s = stats
    assert (s["steps_tile_bound"] >= s["steps_warp_bound"] > s["steps_walked"]
            >= s["steps_contrib"] > s["reductions"] >= -(-s["steps_contrib"] // cc.BWD_GROUP))


@pytest.mark.parametrize("name", ["sparse", "saturating"])
def test_three_sigma_cull_fails_the_count_rule(name):
    """A cull of each pair to its gaussian's 3-sigma box drops the
    contributions between 3 sigma and the 1/255 contour (3.33 sigma at
    opacity 0.99): the exact count sees it, though those contributions are
    too small for the normalised gradient tiers."""
    bwd = _case(name)
    _, n_live, _ = cc.composite_bwd_plain(*bwd, return_evals=True)
    d_live, d_culled, _ = direct_counts(*bwd[:3], bwd[6], bwd[7], bwd[8])
    assert count_rule_fails(d_live, n_live.numpy()) is None
    assert int(d_culled.sum()) < int(d_live.sum())
    assert count_rule_fails(d_culled, n_live.numpy()) is not None


def test_counts_of_an_empty_frame():
    bwd = _case("sparse")
    ts = torch.zeros_like(bwd[0])
    ncon = torch.zeros_like(bwd[6])
    args = (ts,) + bwd[1:6] + (ncon,) + bwd[7:]
    out, n_live, stats = cc.composite_bwd_plain(*args, return_evals=True)
    assert not out.any() and not n_live.any()
    assert stats["steps_tile_bound"] == stats["steps_warp_bound"] == stats["steps_contrib"] == 0
    assert stats["reductions"] == stats["steps_walked"] == 0


def test_counts_wrapper_on_cpu_takes_the_plain_version():
    bwd = _case("sparse")
    before = launches()
    want, n_live, _ = cc.composite_bwd_plain(*bwd, return_evals=True)
    for cull in (True, False):
        got, counts = cc.composite_bwd_counts(*bwd, cull=cull)
        assert torch.equal(got, want) and counts.dtype == torch.int32
        assert torch.equal(counts.long(), n_live)
    assert launches() == before


# --------------------------------------------------------------------------
# the kernels' per-warp cull: footprint_box_plain, the line-for-line
# mirror of csrc/composite_blend.cuh's footprint_box
# --------------------------------------------------------------------------

_F32_MIN = np.float32(1.0 / 255.0)
SWEEP_OPS = [np.nextafter(_F32_MIN, np.float32(0)), _F32_MIN, np.nextafter(_F32_MIN, np.float32(1)),
             np.float32(0.02), np.float32(0.5), np.float32(0.99), np.float32(1.0)]


def _contributes(g, px, py):
    """The kernel's float32 contribution test of gaussian g = (mx, my, a,
    b, c, op) at pixels (px, py)."""
    mx, my, a, b, c, op = (torch.tensor(np.float32(v)) for v in g)
    dx, dy = px - mx, py - my
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(op * torch.exp(power), cc.ALPHA_MAX)
    return (power <= 0.0) & (alpha >= cc.ALPHA_MIN)


def _box(g):
    mx, my, a, b, c, op = (torch.tensor([np.float32(v)]) for v in g)
    return cc.footprint_box_plain(torch.stack([mx, my], 1), torch.stack([a, b, c], 1), op)[0]


def _sweep_gaussians():
    """Seeded conics: round, wide, small, thin at several angles, and b^2
    approaching ac; each at every opacity of SWEEP_OPS."""
    rng = np.random.default_rng(0)
    conics = []
    for lam in [(1.0, 1.0), (0.5, 0.01), (4.0, 4.0), (10.0, 1e-3), (2.0, 2e-5), (0.02, 0.02)]:
        for theta in rng.uniform(0, np.pi, 3):
            cs, sn = np.cos(theta), np.sin(theta)
            rot = np.array([[cs, -sn], [sn, cs]])
            q = rot @ np.diag(lam) @ rot.T
            conics.append((q[0, 0], q[0, 1], q[1, 1]))
    for k in (2, 3, 4, 5):  # b^2 -> ac
        conics.append((1.0, 1.0 - 10.0 ** -k, 1.0))
        conics.append((3.0, -(1.0 - 10.0 ** -k) * np.sqrt(3.0 * 0.5), 0.5))
    out = []
    for a, b, c in conics:
        for op in SWEEP_OPS:
            mx, my = rng.uniform(20, 40, 2)
            out.append((mx, my, a, b, c, op))
    return out


@pytest.mark.parametrize("chunk", range(4))
def test_footprint_box_holds_every_contributing_pixel(chunk):
    """No pixel that passes the kernel's float32 contribution test lies
    outside its gaussian's box: every integer pixel of the box widened by
    two, and points on the 1/255 contour (0.999-1.01 of its radius), pixels
    on the box edge among them. Below opacity 1/255 (one ulp under the cut)
    the box is empty and the centre does not contribute; at the cut and
    one ulp above, the centre does."""
    gs = _sweep_gaussians()
    phi = np.linspace(0, 2 * np.pi, 720, endpoint=False)
    for g in gs[chunk::4]:
        box = _box(g)
        mx, my, a, b, c, op = (np.float32(v) for v in g)
        centre = bool(_contributes(g, torch.tensor(mx), torch.tensor(my)))
        if op < _F32_MIN:
            assert not centre and box[0] == np.inf and box[1] == -np.inf, g
            continue
        assert centre and bool(torch.isfinite(box).all()), g
        xs = torch.arange(np.floor(float(box[0])) - 2, np.ceil(float(box[1])) + 3)
        ys = torch.arange(np.floor(float(box[2])) - 2, np.ceil(float(box[3])) + 3)
        py, px = torch.meshgrid(ys, xs, indexing="ij")
        hit = _contributes(g, px, py)
        assert bool(hit.any()) or op < 0.02  # near the cut the contour may hold no pixel
        inside = (px >= box[0]) & (px <= box[1]) & (py >= box[2]) & (py <= box[3])
        assert not bool((hit & ~inside).any()), g
        # the contour d'Qd = 2 tau, in float64, then rounded to float32 points
        q = np.array([[a, b], [b, c]], np.float64)
        w, vec = np.linalg.eigh(q)
        tau = np.log(255.0 * np.float64(op))
        for r in (0.999, 1.0, 1.001, 1.01):
            d = (vec @ (np.sqrt(2 * tau) * r / np.sqrt(w))[:, None]
                 * np.stack([np.cos(phi), np.sin(phi)]))
            cx = torch.tensor((mx + d[0]).astype(np.float32))
            cy = torch.tensor((my + d[1]).astype(np.float32))
            hit = _contributes(g, cx, cy)
            inside = (cx >= box[0]) & (cx <= box[1]) & (cy >= box[2]) & (cy <= box[3])
            assert not bool((hit & ~inside).any()), (g, r)
        # and the box is no wider than the contour's extent with its margins and a pixel
        det = np.float64(a) * c - np.float64(b) ** 2
        hx = np.sqrt((2 * max(tau, 0) * (1.001 + 4e-6 * a * c / det) + 1e-5) * c / det)
        assert float(box[1] - box[0]) / 2 <= hx * 1.001 + 1.001, g


def test_footprint_box_gives_up_on_what_it_cannot_bound():
    """The full plane for anything non-finite, a conic that is not positive
    definite, or a box wider than 1e5 pixels; never a smaller box."""
    full = torch.tensor([-np.inf, np.inf, -np.inf, np.inf])
    for g in [(np.nan, 1, 1, 0, 1, 0.5), (1, 1, np.inf, 0, 1, 0.5), (1, 1, 1, 0, 1, np.inf),
              (1, 1, 1, 0, 1, np.nan), (1, 1, 1, 1, 1, 0.5), (1, 1, 1, 2, 1, 0.5),
              (1, 1, -1, 0, 1, 0.5), (1, 1, 1, 0, 0, 0.5), (1, 1, 1e-12, 0, 1, 0.5),
              (2e5, 1, 1, 0, 1, 0.5)]:
        assert torch.equal(_box(g), full), g


SWEEP_BLOCK = 64  # pixels: each sweep gaussian has a 64x64 block of its own
SWEEP_COLS = 14


def sweep_frame(device):
    """The sweep's gaussians as one frame's kernel inputs ``(tile_start,
    pair_gauss, attrs, tiles_x, tiles_y)``: gaussian i, its mean moved into
    its own 64x64 block, is the front pair of each of the block's 16 tiles;
    behind it a faint wide gaussian reaches every pixel, so every warp
    replays both pairs and only the cull can skip the first."""
    gs = np.array(_sweep_gaussians(), np.float64)
    n = len(gs)
    rows = -(-n // SWEEP_COLS)
    bt = SWEEP_BLOCK // 16
    tiles_x, tiles_y = SWEEP_COLS * bt, rows * bt
    t = np.arange(tiles_x * tiles_y)
    block = (t // tiles_x) // bt * SWEEP_COLS + (t % tiles_x) // bt
    block = block[block < n]
    assert block.size == t.size  # no empty block: the grid is full
    pair_gauss = np.stack([block, n + block], 1).reshape(-1)
    tile_start = 2 * np.arange(t.size + 1)
    origin = SWEEP_BLOCK * np.stack([np.arange(n) % SWEEP_COLS, np.arange(n) // SWEEP_COLS], 1)
    means = np.concatenate([gs[:, :2] + origin, origin + SWEEP_BLOCK / 2])
    conics = np.concatenate([gs[:, 2:5], np.tile([1e-5, 0.0, 1e-5], (n, 1))])
    opac = np.concatenate([gs[:, 5], np.full(n, 0.05)])
    colors = np.random.default_rng(1).uniform(0.1, 0.9, (2 * n, 3))

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    attrs = cc.pack_gauss_attrs(f32(means), f32(conics), f32(colors), f32(opac))
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.tensor(tile_start, **i32), torch.tensor(pair_gauss, **i32), attrs,
            tiles_x, tiles_y)


def test_sweep_frame_counts_match_direct_count():
    """The cull sweep's gaussians through the backward's plain version: its
    counts, the steps left after the cull among them, equal to the direct
    numpy count, which also finds no contributing pixel outside its box;
    the cull skips the front pair in the strips its box misses."""
    with torch.no_grad():
        bwd = _bwd_inputs(sweep_frame("cpu"))
    _, n_live, stats = cc.composite_bwd_plain(*bwd, return_evals=True)
    d_live, _, want = direct_counts(*bwd[:3], bwd[6], bwd[7], bwd[8])
    assert np.array_equal(n_live.numpy(), d_live)
    for key in ("steps_warp_bound", "steps_walked", "steps_contrib", "reductions"):
        assert stats[key] == want[key], key
    n_warps = 8 * bwd[7] * bwd[8]
    assert stats["steps_warp_bound"] == 2 * n_warps  # the faint one reaches every pixel
    assert n_warps < stats["steps_walked"] < stats["steps_warp_bound"]
    assert stats["steps_contrib"] > n_warps


@pytest.mark.cuda
def test_cull_loses_nothing_on_the_sweep_frame():
    """The device's cull (``footprint_box`` on the card's arithmetic) on
    the sweep's thin, wide, near-singular and near-1/255 gaussians: the
    counts with it equal those without it on every pixel."""
    dev = _cuda()
    with torch.no_grad():
        bwd = _bwd_inputs(sweep_frame(dev))
    assert_cull_loses_nothing(bwd)


def test_bwd_work_from_the_plain_counts():
    """``profiling.bwd_work``: shuffles of the reduce-scatters and of the
    first version's butterflies, and the per-tile tail, from the counts."""
    from gsjax_torch.utils.profiling import bwd_work

    _, _, stats = cc.composite_bwd_plain(*_case("saturating"), return_evals=True)
    w = bwd_work(stats)
    assert w["shuffles"] == 81 * stats["reductions"] > 0
    assert w["shuffles_first_version"] == 45 * stats["steps_contrib"] > w["shuffles"]
    maxn = stats["maxn"].numpy().astype(np.float64)
    assert w["maxn_max"] == maxn.max() and w["maxn_mean"] == pytest.approx(maxn.mean())
    assert w["maxn_p99"] == pytest.approx(np.quantile(maxn, 0.99))
    deep = np.sort(maxn)[::-1][:-(-maxn.size // 100)]
    assert w["walk_share_deepest_1pct"] == pytest.approx(deep.sum() / maxn.sum())
