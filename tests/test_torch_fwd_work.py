"""The forward kernels' per-warp cull and work counts, on the CPU.

The forward kernels (``composite_infer``, ``composite_fwd``) skip, in each
16x2 warp strip, the pairs whose footprint box (``footprint_box_plain``)
misses it. The cull must be exact: the training forward's plain version
with the cull applied equals it without the cull bit for bit (colors, T,
``n_contrib``), on a small sparse and a small saturating scene and on the
cull sweep's frame, while a cull to each gaussian's 3-sigma box changes
the outputs. ``profiling.fwd_work``'s warp-level counts are held against
a direct numpy count of the sequential walk. The card tests
(``tests/test_torch_cuda.py``) hold the kernels against their check
instance without the cull. Imports no JAX:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_fwd_work.py
"""

import numpy as np
import pytest
import torch

from gsjax_torch.ops import cuda_composite as cc
from gsjax_torch.utils.profiling import fwd_work, launches
from test_torch_bwd_counts import sweep_frame
from test_torch_cuda import _inputs, _scene, footprint_box_np

CASES = {"sparse": (False, (70, 45)), "saturating": (True, (70, 45))}


def _frame(name):
    if name == "sweep":
        return sweep_frame("cpu")
    dense, size = CASES[name]
    with torch.no_grad():
        return _inputs(_scene(300, 4, dense), *size, "cpu")


def _gauss(attrs):
    means2d, conics, _, opacities = cc.unpack_gauss_attrs(attrs)
    return means2d, conics, opacities


def direct_fwd_counts(tile_start, pair_gauss, attrs, tiles_x, tiles_y):
    """The forward's walk pair by pair in numpy float32, as the kernel's
    sequential recurrence runs it: per pixel, ``n_eval`` (pairs evaluated
    up to and including the one that ends it) and ``n_contrib``; per warp,
    the steps up to its last lane's exit, those whose box
    (:func:`footprint_box_np`) meets its strip, and those with a blending
    lane; the evaluations and blends."""
    ts, pg = tile_start.numpy(), pair_gauss.numpy()
    a = attrs.numpy()
    op = np.ascontiguousarray(a[:, 5:7]).view(np.float16).astype(np.float32)[:, 2]
    boxes = footprint_box_np(a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4], op)
    num_tiles = tiles_x * tiles_y
    pix = np.arange(256)
    n_eval = np.zeros((num_tiles, 256), np.int64)
    n_contrib = np.zeros((num_tiles, 256), np.int64)
    stats = dict.fromkeys(("steps_exit_bound", "steps_walked", "steps_blend", "evals",
                           "blends"), 0)
    for t in range(num_tiles):
        g = pg[ts[t]:ts[t + 1]]
        m = g.size
        px = ((t % tiles_x) * 16 + pix % 16).astype(np.float32)
        py = ((t // tiles_x) * 16 + pix // 16).astype(np.float32)
        T = np.ones(256, np.float32)
        done = np.zeros(256, bool)
        blend = np.zeros((256, m), bool)
        for j, gi in enumerate(g):
            n_eval[t] += ~done
            dx, dy = px - a[gi, 0], py - a[gi, 1]
            power = np.float32(-0.5) * (a[gi, 2] * dx * dx + a[gi, 4] * dy * dy) \
                - a[gi, 3] * dx * dy
            alpha = np.minimum(np.float32(0.99), op[gi] * np.exp(power))
            ok = ~done & (power <= 0) & (alpha >= np.float32(1.0 / 255.0))
            test_T = T * (np.float32(1.0) - alpha)
            trip = ok & (test_T < np.float32(1e-4))
            blend[:, j] = ok & ~trip
            T = np.where(blend[:, j], test_T, T)
            n_contrib[t] = np.where(blend[:, j], j + 1, n_contrib[t])
            done |= trip
        wmax = n_eval[t].reshape(8, 32).max(1)
        x0, y0 = (t % tiles_x) * 16, (t // tiles_x) * 16 + 2 * np.arange(8)[:, None]
        bx = boxes[g]
        meets = ((bx[:, 0] <= x0 + 15) & (bx[:, 1] >= x0) & (bx[:, 2] <= y0 + 1)
                 & (bx[:, 3] >= y0))  # (warp, local pair)
        steps = blend.reshape(8, 32, m).any(1)
        assert not (steps & ~meets).any(), "a blending pair outside its box"
        stats["steps_exit_bound"] += int(wmax.sum())
        stats["steps_walked"] += int((meets & (np.arange(m) < wmax[:, None])).sum())
        stats["steps_blend"] += int(steps.sum())
        stats["blends"] += int(blend.sum())
    stats["evals"] = int(n_eval.sum())
    return n_eval, n_contrib, stats


@pytest.mark.parametrize("name", list(CASES))
def test_fwd_work_matches_direct_count(name):
    args = _frame(name)
    _, _, ncon, stats = cc.composite_fwd_plain(*args, return_evals=True)
    n_eval = cc.composite_infer_plain(*args, return_evals=True)[2]
    d_eval, d_ncon, want = direct_fwd_counts(*args)
    assert np.array_equal(n_eval.numpy(), d_eval) and np.array_equal(ncon.numpy(), d_ncon)
    work = fwd_work(*args)
    for key, v in want.items():
        assert stats[key] == work[key] == v, key
    assert work["walked_share"] == want["steps_walked"] / want["steps_exit_bound"]
    s = want
    assert s["steps_exit_bound"] > s["steps_walked"] > s["steps_blend"] > 0
    assert s["blends"] <= 32 * s["steps_blend"] and s["evals"] <= 32 * s["steps_exit_bound"]
    if name == "saturating":  # warps end early: fewer steps than every pair per warp
        assert s["steps_exit_bound"] < 8 * int(args[0][-1])


@pytest.mark.parametrize("name", ["sparse", "saturating", "sweep"])
def test_footprint_cull_changes_nothing(name):
    """The plain forward with the kernels' cull equals it without the cull,
    bit for bit: colors, T and n_contrib on every pixel."""
    args = _frame(name)
    want = cc.composite_fwd_plain(*args)
    got = cc.composite_fwd_plain(*args, boxes=cc.footprint_box_plain(*_gauss(args[2])))
    assert int(want[2].max()) > 0
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def _three_sigma_boxes(means2d, conics, opacities):
    a, b, c = (conics[:, i].double() for i in range(3))
    det = a * c - b * b
    hx, hy = 3 * torch.sqrt(c / det), 3 * torch.sqrt(a / det)
    mx, my = means2d[:, 0].double(), means2d[:, 1].double()
    return torch.stack([mx - hx, mx + hx, my - hy, my + hy], 1).float()


@pytest.mark.parametrize("name", list(CASES))
def test_three_sigma_cull_changes_the_outputs(name):
    """A cull to each gaussian's 3-sigma box skips the blends between 3
    sigma and the 1/255 contour (3.33 sigma at opacity 0.99): the
    bit-for-bit comparison above sees it."""
    args = _frame(name)
    want = cc.composite_fwd_plain(*args)
    got = cc.composite_fwd_plain(*args, boxes=_three_sigma_boxes(*_gauss(args[2])))
    assert not torch.equal(want[0], got[0]) and not torch.equal(want[1], got[1])
    assert int((got[2] != want[2]).sum()) > 0


def test_check_wrapper_on_cpu_takes_the_plain_version():
    args = _frame("sparse")
    want = cc.composite_fwd_plain(*args)
    before = launches()
    for w, g in zip(want, cc.composite_fwd_check(*args)):
        assert torch.equal(w, g)
    assert launches() == before
