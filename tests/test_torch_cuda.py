"""The CUDA compositing kernels on the card, against their plain versions.

Imports neither JAX nor gsjax nor the shared conftest helpers, so it runs
where only the port is installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

Tests marked ``cuda`` skip (inside the test) without a CUDA device; the
input checks run anywhere.
"""

import numpy as np
import pytest
import torch

from gsjax_torch.data.cameras import Camera
from gsjax_torch.ops import RasterizeSettings, render
from gsjax_torch.ops import cuda_composite as cc
from gsjax_torch.ops import cuda_probe as cp
from gsjax_torch.ops.binning import build_tile_bins
from gsjax_torch.ops.projection import num_tiles, preprocess
from gsjax_torch.utils import prng


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(n, seed, dense=False):
    """Post-activation gaussians in front of an identity camera (numpy)."""
    rng = np.random.default_rng(seed)
    spread, z = (0.6, (3.0, 4.0)) if dense else (2.0, (4.0, 10.0))
    means = np.stack([rng.uniform(-spread, spread, n), rng.uniform(-spread, spread, n),
                      rng.uniform(*z, n)], 1)
    scales = np.exp(rng.normal(-2.2, 0.4, (n, 3)))
    quats = rng.normal(0, 1, (n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.6, 0.99, n) if dense else rng.uniform(0.2, 0.95, n)
    shs = rng.normal(0, 0.15, (n, 16, 3))
    shs[:, 0] = rng.uniform(-1.0, 1.5, (n, 3))
    return [a.astype(np.float32) for a in (means, scales, quats, opac, shs)]


def _camera(width, height, device):
    return Camera(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3), fov_x=0.8,
                  fov_y=0.8 * height / width, width=width,
                  height=height).to_render_camera(device)


def _inputs(gs, width, height, device, max_pairs=1 << 15):
    rc = _camera(width, height, device)
    sp = preprocess(*(torch.from_numpy(g).to(device) for g in gs), rc, 3)
    tx, ty = num_tiles(width, height)
    bins = build_tile_bins(sp, tx, ty, max_pairs, max_tiles_per_gauss=16,
                           expansion="compact")
    attrs = cc.pack_gauss_attrs(sp.means2d, sp.conics, sp.colors, sp.opacities)
    return bins.tile_start, bins.pair_gauss, attrs, tx, ty


def assert_two_tier(got, want, name, tol=1e-4):
    """The sequential recurrence (kernel) against the chunked cumulative
    product (plain version): float reassociation, plus a pair on the 1/255
    cut or the 1e-4 exit taken by one and not the other — at most 0.1% of
    the values past ``tol``, none past 6e-3."""
    d = (got.double().cpu() - want.double().cpu()).abs().numpy()
    assert np.isfinite(d).all(), name
    assert (d > tol).mean() <= 1e-3 and d.max() <= 6e-3, (name, d.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
@pytest.mark.parametrize("size", [(64, 64), (70, 45)])
def test_kernel_matches_plain_version(dense, size):
    dev = _cuda()
    args = _inputs(_scene(300, 4, dense), *size, dev)
    before = cc.composite_infer.launches
    kc, kT = cc.composite_infer(*args)
    torch.cuda.synchronize()
    assert cc.composite_infer.launches == before + 1
    pc, pT = cc.composite_infer_plain(*args)
    assert_two_tier(kc, pc, "tile_colors")
    assert_two_tier(kT, pT, "tile_T")
    if dense:
        assert float(kT.min()) < 1e-3  # pixels saturate: the early exit runs


@pytest.mark.cuda
def test_kernel_empty_tiles_and_no_pairs():
    dev = _cuda()
    gs = _scene(50, 1)
    gs[0][:, 2] *= -1  # everything behind the camera: every range is empty
    kc, kT = cc.composite_infer(*_inputs(gs, 48, 40, dev))
    torch.cuda.synchronize()
    assert float(kc.abs().max()) == 0.0 and bool((kT == 1.0).all())


@pytest.mark.cuda
def test_render_on_cuda_matches_cpu():
    dev = _cuda()
    gs = _scene(300, 7)
    bg = torch.tensor([0.1, 0.2, 0.3])
    s = RasterizeSettings(max_pairs=1 << 15)
    with torch.no_grad():
        gpu = render(_camera(80, 48, dev), *(torch.from_numpy(g).to(dev) for g in gs), 3,
                     bg.to(dev), s)  # auto -> kernel
        cpu = render(_camera(80, 48, "cpu"), *map(torch.from_numpy, gs), 3, bg, s)
    assert_two_tier(gpu["render"], cpu["render"], "render")
    assert_two_tier(gpu["final_T"], cpu["final_T"], "final_T")
    assert torch.equal(gpu["radii"].cpu(), cpu["radii"])
    for k in ("num_dropped", "num_mt_capped", "num_tier_capped"):
        assert int(gpu[k]) == int(cpu[k]), k


@pytest.mark.cuda
def test_kernel_f16_overflow_matches_plain_version():
    """A color above 65504 decodes as 65536 in the kernel, as in gsjax's
    Pallas decode and the plain version (``cuda_composite.decode_f16_pair``):
    the kernel backend's image is finite and equals the plain version's on
    the CPU within the kernel tiers (see
    tests/test_torch_render.py::test_f16_color_overflow); the scan backend
    keeps the inf on exactly the pixels the gaussian covers."""
    dev = _cuda()
    gs = _scene(40, 0)
    colors = torch.from_numpy(np.random.default_rng(0).uniform(0.1, 0.9, (40, 3))
                              .astype(np.float32))
    colors[0, 1] = 7e4
    outs = {}
    with torch.no_grad():
        for d, b in ((dev, "kernel"), (dev, "scan"), (torch.device("cpu"), "kernel")):
            outs[d.type, b] = render(
                _camera(64, 64, d), *(torch.from_numpy(g).to(d) for g in gs), 3,
                torch.zeros(3, device=d), RasterizeSettings(backend=b),
                colors_precomp=colors.to(d))["render"].cpu()
    kern, plain, scan = outs["cuda", "kernel"], outs["cpu", "kernel"], outs["cuda", "scan"]
    assert bool(torch.isfinite(kern).all())
    covered = torch.isinf(scan).any(-1)
    assert bool(covered.any()) and not bool(torch.isnan(scan).any())
    assert float(kern[covered][:, 1].max()) > 1e3
    # the covered pixels hold 65536 alpha T: the tiers relative to their size
    assert_two_tier(kern[~covered], plain[~covered], "uncovered pixels")
    scale = plain[covered].abs().clamp_min(1.0)
    assert_two_tier(kern[covered] / scale, plain[covered] / scale, "covered pixels")
    assert_two_tier(kern[~covered], scan[~covered], "scan, uncovered pixels")


def assert_norm_tiers(got, want, name, p999=1e-3, mx=2e-2):
    """Gradients normalised by max |want|: p99.9 of |got - want| within
    ``p999``, every value within ``mx`` (a pair on the 1/255 cut or the
    1e-4 exit taken by one version and not the other moves its gradients
    by a whole contribution)."""
    got, want = got.double().cpu(), want.double().cpu()
    assert bool(torch.isfinite(got).all()), name
    d = ((got - want).abs() / max(float(want.abs().max()), 1e-12)).flatten().sort().values
    assert float(d[int(0.999 * (d.numel() - 1))]) <= p999 and float(d[-1]) <= mx, (
        name, float(d[-1]))


def _bwd_inputs(args, seed=0):
    tile_start, pair_gauss, attrs, tx, ty = args
    tc, tT, ncon = cc.composite_fwd(*args)
    g = torch.Generator(device=tc.device).manual_seed(seed)
    d_colors = torch.randn(tc.shape, generator=g, device=tc.device)
    d_T = torch.randn(tT.shape, generator=g, device=tc.device)
    return (tile_start, pair_gauss, attrs, d_colors, d_T, tT, ncon, tx, ty)


def direct_counts(tile_start, pair_gauss, attrs, n_contrib, tiles_x, tiles_y):
    """The backward's contributing (pair, pixel) set counted directly in
    numpy float32, tile by tile: a pair contributes to a pixel when its
    local index is below the pixel's n_contrib, power <= 0 and
    min(0.99, op exp(power)) >= 1/255. Returns ``(n_live (T, 256),
    n_live of the same set culled to each gaussian's 3-sigma box (T, 256),
    warp stats as cuda_composite._bwd_warp_stats)``; ``steps_walked``
    counts the steps whose pair's :func:`footprint_box_np` meets the
    warp's 16x2 strip."""
    ts, pg = tile_start.cpu().numpy(), pair_gauss.cpu().numpy()
    a = attrs.cpu().numpy()
    halves = np.ascontiguousarray(a[:, 5:7]).view(np.float16).astype(np.float32)
    op = halves[:, 2]  # per word the low half first: g, r, opacity, b
    boxes = footprint_box_np(a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4], op)
    ncon = n_contrib.cpu().numpy().astype(np.int64)
    num_tiles = tiles_x * tiles_y
    pix = np.arange(256)
    n_live = np.zeros((num_tiles, 256), np.int64)
    n_culled = np.zeros((num_tiles, 256), np.int64)
    maxn = ncon.max(1)
    wmax = ncon.reshape(num_tiles, 8, 32).max(2)
    batch, group = cc.BWD_BATCH, cc.BWD_GROUP
    steps_contrib, steps_walked, reductions = 0, 0, 0
    for t in range(num_tiles):
        m = int(maxn[t])
        if m == 0:
            continue
        g = pg[ts[t]:ts[t] + m]
        px = ((t % tiles_x) * 16 + pix % 16).astype(np.float32)[:, None]
        py = ((t // tiles_x) * 16 + pix // 16).astype(np.float32)[:, None]
        qa, qb, qc = (a[g, 2 + i][None, :] for i in range(3))
        dx, dy = px - a[g, 0][None, :], py - a[g, 1][None, :]
        power = np.float32(-0.5) * (qa * dx * dx + qc * dy * dy) - qb * dx * dy
        alpha = np.minimum(np.float32(0.99), op[g][None, :] * np.exp(power))
        live = ((np.arange(m)[None, :] < ncon[t][:, None]) & (power <= 0)
                & (alpha >= np.float32(1.0 / 255.0)))
        n_live[t] = live.sum(1)
        det = qa.astype(np.float64) * qc - qb.astype(np.float64) ** 2
        box = (np.abs(dx) <= 3 * np.sqrt(qc / det)) & (np.abs(dy) <= 3 * np.sqrt(qa / det))
        n_culled[t] = (live & box).sum(1)
        steps = live.reshape(8, 32, m).any(1)  # (warp, local pair)
        bx = boxes[g]
        x0, y0 = (t % tiles_x) * 16, (t // tiles_x) * 16 + 2 * np.arange(8)[:, None]
        meets = ((bx[:, 0] <= x0 + 15) & (bx[:, 1] >= x0) & (bx[:, 2] <= y0 + 1)
                 & (bx[:, 3] >= y0))  # (warp, local pair)
        steps_walked += int((meets & (np.arange(m) < wmax[t][:, None])).sum())
        assert not (steps & ~meets).any(), "a contributing pair outside its box"
        bid = (m - 1 - np.arange(m)) // batch
        per_batch = np.stack([np.bincount(bid, weights=steps[w], minlength=bid.max() + 1)
                              for w in range(8)]).astype(np.int64)
        steps_contrib += int(per_batch.sum())
        reductions += int(-(-per_batch // group).sum())
    stats = {"steps_tile_bound": 8 * int(maxn.sum()), "steps_warp_bound": int(wmax.sum()),
             "steps_walked": steps_walked, "steps_contrib": steps_contrib,
             "reductions": reductions, "maxn": maxn}
    return n_live, n_culled, stats


def footprint_box_np(mx, my, a, b, c, op):
    """``footprint_box`` of ``csrc/composite_blend.cuh`` in numpy float32 (N, 4)."""
    with np.errstate(all="ignore"):
        det = a * c - b * b
        tau = np.maximum(np.log(255.0 * op), np.float32(0.0))
        tau2 = 2.0 * tau * (1.001 + 4e-6 * (a * c / det)) + 1e-5
        hx = np.sqrt(tau2 * c / det) + 1.0
        hy = np.sqrt(tau2 * a / det) + 1.0
        box = np.stack([mx - hx, mx + hx, my - hy, my + hy], 1).astype(np.float32)
        finite = np.isfinite(np.stack([mx, my, a, b, c, op])).all(0)
        ok = ((a > 0) & (c > 0) & (det > 0) & (hx < 1e5) & (hy < 1e5) & (np.abs(mx) < 1e5)
              & (np.abs(my) < 1e5))
    full = np.array([-np.inf, np.inf, -np.inf, np.inf], np.float32)
    box = np.where(ok[:, None], box, full)
    box = np.where((op >= np.float32(1.0 / 255.0))[:, None], box, -full)
    return np.where(finite[:, None], box, full)


def count_rule_fails(got, want):
    """The exact-count rule (chip_smoke.py): per-pixel counts equal on at
    least 99.9% of pixels, totals within 1e-4 relative and sum |got -
    want| at most 32. Returns the reason it fails, or None."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    agree = float((got == want).mean())
    rel = abs(int(got.sum()) - int(want.sum())) / max(int(want.sum()), 1)
    off = int(np.abs(got - want).sum())
    if agree < 0.999 or rel > 1e-4 or off > 32:
        return f"equal on {agree:.5f} of pixels, sum |diff| {off}, totals " \
               f"{int(got.sum())} vs {int(want.sum())} ({rel:.2e} relative)"
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
@pytest.mark.parametrize("size", [(64, 64), (70, 45)])
def test_fwd_kernel_matches_plain_version_and_infer(dense, size):
    dev = _cuda()
    args = _inputs(_scene(300, 4, dense), *size, dev)
    before = cc.composite_fwd.launches
    kc, kT, kn = cc.composite_fwd(*args)
    torch.cuda.synchronize()
    assert cc.composite_fwd.launches == before + 1
    pc, pT, pn = cc.composite_fwd_plain(*args)
    assert_two_tier(kc, pc, "tile_colors")
    assert_two_tier(kT, pT, "tile_T")
    assert kn.dtype == torch.int32 and float((kn == pn).float().mean()) >= 0.999
    ic, iT = cc.composite_infer(*args)  # the same recurrence: bit for bit
    assert torch.equal(ic, kc) and torch.equal(iT, kT)


def assert_fwd_cull_loses_nothing(args):
    """The forward kernels on the card against their check instance, the
    walk of every pair without the per-warp cull: colors, T and n_contrib
    bit for bit, for composite_fwd and composite_infer (colors and T);
    each launch counted by its own wrapper."""
    launches = lambda: (cc.composite_infer.launches, cc.composite_fwd.launches,  # noqa: E731
                        cc.composite_fwd_check.launches)
    before = launches()
    want = cc.composite_fwd_check(*args)
    got = cc.composite_fwd(*args)
    ic, iT = cc.composite_infer(*args)
    torch.cuda.synchronize()
    assert launches() == (before[0] + 1, before[1] + 1, before[2] + 1)
    assert int(want[2].max()) > 0
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert torch.equal(ic, want[0]) and torch.equal(iT, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
@pytest.mark.parametrize("size", [(64, 64), (70, 45)])
def test_fwd_cull_loses_nothing(dense, size):
    assert_fwd_cull_loses_nothing(_inputs(_scene(300, 4, dense), *size, _cuda()))


@pytest.mark.cuda
def test_fwd_cull_loses_nothing_on_the_sweep_frame():
    """The device's cull on the sweep's thin, wide, near-singular and
    near-1/255 gaussians (tests/test_torch_bwd_counts.py)."""
    from test_torch_bwd_counts import sweep_frame

    with torch.no_grad():
        assert_fwd_cull_loses_nothing(sweep_frame(_cuda()))


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
def test_bwd_kernel_matches_plain_version(dense):
    dev = _cuda()
    args = _inputs(_scene(300, 4, dense), 70, 45, dev)
    bwd = _bwd_inputs(args)
    before = cc.composite_bwd.launches
    kg = cc.composite_bwd(*bwd)
    torch.cuda.synchronize()
    assert cc.composite_bwd.launches == before + 1
    pg = cc.composite_bwd_plain(*bwd)
    assert float(pg.abs().max()) > 0
    for i, name in enumerate(("mean_x", "mean_y", "conic_a", "conic_b", "conic_c",
                              "opacity", "r", "g", "b")):
        assert_norm_tiers(kg[:, i], pg[:, i], name)
    n = args[2].shape[0]
    kr = cc.reduce_pair_grads(kg, args[1], args[0], n)
    pr = cc.reduce_pair_grads(pg, args[1], args[0], n)
    for i in range(9):
        assert_norm_tiers(kr[:, i], pr[:, i], f"per-gaussian {i}")


def assert_cull_loses_nothing(bwd):
    """The backward's check instances on the card: with the per-warp cull
    and without it, the same counts on every pixel and the same table bit
    for bit, both :func:`cc.composite_bwd`'s; the counts within the
    exact-count rule of the plain version's. Returns the counts."""
    before = cc.composite_bwd.launches, cc.composite_bwd_counts.launches
    kg, counts = cc.composite_bwd_counts(*bwd)
    ng, n_counts = cc.composite_bwd_counts(*bwd, cull=False)
    torch.cuda.synchronize()
    assert (cc.composite_bwd.launches, cc.composite_bwd_counts.launches) == (
        before[0], before[1] + 2)
    assert counts.dtype == torch.int32 and counts.shape == bwd[6].shape
    assert torch.equal(counts, n_counts)
    assert torch.equal(kg, ng) and torch.equal(kg, cc.composite_bwd(*bwd))
    _, n_live, _ = cc.composite_bwd_plain(*bwd, return_evals=True)
    assert int(n_live.sum()) > 0
    assert count_rule_fails(counts.cpu(), n_live.cpu()) is None
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
def test_bwd_count_instance_matches_plain_version(dense):
    """The kernel's per-pixel count of contributing pairs, with and without
    its cull, against the plain version's (the NCON_AGREE rule: expf
    against torch.exp at the 1/255 cut), its table bit for bit the
    training instance's; and a 3-sigma cull, counted from the same inputs,
    fails the rule."""
    dev = _cuda()
    args = _inputs(_scene(300, 4, dense), 70, 45, dev)
    bwd = _bwd_inputs(args)
    counts = assert_cull_loses_nothing(bwd)
    _, culled, _ = direct_counts(*bwd[:3], bwd[6], bwd[7], bwd[8])
    assert count_rule_fails(culled, counts.cpu()) is not None


@pytest.mark.cuda
def test_bwd_kernel_and_reduction_are_deterministic():
    dev = _cuda()
    args = _inputs(_scene(300, 9, True), 80, 64, dev)
    bwd = _bwd_inputs(args, seed=3)
    runs = [cc.composite_grads(*bwd) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


BF16_MODES = [("sort", True), ("gather", False)]  # grad_reduce, its half-up rounding


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
@pytest.mark.parametrize("reduce,half_up", BF16_MODES, ids=["sort", "gather"])
def test_bwd_bf16_kernel_packs_its_float32_table(reduce, half_up, dense):
    """At grad_dtype bfloat16 the kernel writes the (P, 5) packed table
    itself: bit for bit ``pack_bf16_pairs`` of its own float32 table (the
    same float32 arithmetic, then gsjax's rounding), within the tiers of the
    plain version after unpacking, per pair and per gaussian; the check
    instances write the same table."""
    dev = _cuda()
    args = _inputs(_scene(300, 4, dense), 70, 45, dev)
    bwd = _bwd_inputs(args)
    kf = cc.composite_bwd(*bwd)
    before = cc.composite_bwd.launches, cc.composite_bwd.launches_bf16
    kb = cc.composite_bwd(*bwd, grad_dtype="bfloat16", grad_reduce=reduce)
    torch.cuda.synchronize()
    assert (cc.composite_bwd.launches, cc.composite_bwd.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    assert kb.dtype == torch.int32 and kb.shape == (bwd[1].shape[0], 5)
    assert torch.equal(kb, cc.pack_bf16_pairs(kf, half_up=half_up))
    pb = cc.composite_bwd_plain(*bwd, grad_dtype="bfloat16", grad_reduce=reduce)
    ku, pu = cc.unpack_bf16_pairs(kb), cc.unpack_bf16_pairs(pb)
    assert float(pu.abs().max()) > 0
    for i in range(9):
        assert_norm_tiers(ku[:, i], pu[:, i], f"pair {i}")
    n = args[2].shape[0]
    kr = cc.reduce_pair_grads(kb, args[1], args[0], n)
    pr = cc.reduce_pair_grads(pb, args[1], args[0], n)
    for i in range(9):
        assert_norm_tiers(kr[:, i], pr[:, i], f"per-gaussian {i}")
    for cull in (True, False):
        table, _ = cc.composite_bwd_counts(*bwd, cull=cull, grad_dtype="bfloat16",
                                           grad_reduce=reduce)
        assert torch.equal(table, kb)


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["sort", "gather"])
def test_bwd_bf16_path_is_deterministic(reduce):
    dev = _cuda()
    args = _inputs(_scene(300, 9, True), 80, 64, dev)
    bwd = _bwd_inputs(args, seed=3)
    runs = [cc.composite_grads(*bwd, grad_dtype="bfloat16", grad_reduce=reduce)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_path_launches_the_training_kernels():
    _autograd_path_launches("float32", "sort")


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["sort", "gather"])
def test_autograd_path_launches_the_training_kernels_bf16(reduce):
    _autograd_path_launches("bfloat16", reduce)


def _autograd_path_launches(grad_dtype, grad_reduce):
    """render() with gradients launches composite_fwd and composite_bwd
    once each (the bf16 instance at bfloat16), without them composite_infer
    only; the card's gradients within the tiers of the CPU's."""
    dev = _cuda()
    gs = _scene(300, 7)
    s = RasterizeSettings(max_pairs=1 << 15)
    counts = lambda: (cc.composite_infer.launches, cc.composite_fwd.launches,  # noqa: E731
                      cc.composite_bwd.launches, cc.composite_bwd.launches_bf16)
    bf16 = int(grad_dtype == "bfloat16")
    grads = {}
    for device in (dev, torch.device("cpu")):
        leaves = [torch.from_numpy(g).to(device).requires_grad_(True) for g in gs]
        before = counts()
        out = render(_camera(80, 48, device), *leaves, 3, torch.zeros(3, device=device),
                     RasterizeSettings(max_pairs=1 << 15, backend="kernel",
                                       grad_dtype=grad_dtype, grad_reduce=grad_reduce))
        (out["render"] * out["render"]).sum().backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert counts() == (before[0], before[1] + 1, before[2] + 1, before[3] + bf16)
        grads[device.type] = [x.grad for x in leaves]
    for name, a, b in zip(("means3d", "scales", "quats", "opacities", "shs"),
                          grads["cuda"], grads["cpu"]):
        assert_norm_tiers(a, b, name)
    before = counts()
    with torch.no_grad():
        render(_camera(80, 48, dev), *(torch.from_numpy(g).to(dev) for g in gs), 3,
               torch.zeros(3, device=dev), s)
    assert counts() == (before[0] + 1, before[1], before[2], before[3])


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [8, 24, 48], ids=["w8", "w24", "w48"])
@pytest.mark.parametrize("k", [(4, 0), (40, 0), (20, 0), (20, 5), (20, 10)],
                         ids=["k4", "k40", "f20e0", "f20e5", "f20e10"])
def test_sol_probe_matches_plain_version(k, warps):
    """The speed-of-light probe against its plain version at each
    occupancy: relative 2e-5 (one FMA against two roundings, and another
    order of the lane sum; measured 1.9e-6 at the 1080p bench frame).
    Tiles: empty at an aligned and at an unaligned start, 1 to 300 pairs,
    then 300 random ones. The instance runs at its occupancy with nothing
    spilled."""
    _check_sol_probe(k, cp.PROBE_EXP, warps)
    info = cp.sol_probe_info(*k, warps)
    assert info["resident_warps"] == warps and info["local_bytes"] == 0, info


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [8, 24, 48], ids=["w8", "w24", "w48"])
@pytest.mark.parametrize("k_exp", [5, 10], ids=["f20e5", "f20e10"])
def test_sol_probe_check_coefs_match_plain_version(k_exp, warps):
    """The exp instances under the check coefficients, where every pass and
    chunk shows in the output (under the sessions' own, an exp pass forgets
    its input and the comparison above cannot see a wrong pass count)."""
    _check_sol_probe((20, k_exp), cp.check_exp_coefs(20), warps)
    info = cp.sol_probe_info(20, k_exp, warps, check=True)
    assert info["resident_warps"] == warps and info["local_bytes"] == 0, info


def _check_sol_probe(k, coefs, warps):
    dev = _cuda()
    counts = np.concatenate([[0, 5, 0, 1, 127, 128, 130, 300],
                             np.random.default_rng(0).integers(0, 700, 300)])
    ts = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32,
                      device=dev)
    table = cp.sol_probe_inputs(ts, seed=3)
    before = cp.sol_probe.launches
    got = cp.sol_probe(ts, table, *k, coefs, warps_per_sm=warps)
    torch.cuda.synchronize()
    assert cp.sol_probe.launches == before + 1
    want = cp.sol_probe_plain(ts, table, *k, coefs)
    assert float(want[0].abs().max()) == 0.0 and float(want[2].abs().min()) > 0.0
    torch.testing.assert_close(got, want, rtol=2e-5, atol=0.0)


def test_wrapper_checks_inputs():
    ts = torch.zeros(5, dtype=torch.int32)
    pg = torch.zeros(3, dtype=torch.int32)
    attrs = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="tile_start"):
        cc.composite_infer(ts.long(), pg, attrs, 2, 2)
    with pytest.raises(ValueError, match="tile_start"):
        cc.composite_infer(ts[:4], pg, attrs, 2, 2)
    with pytest.raises(ValueError, match="pair_gauss"):
        cc.composite_infer(ts, pg.float(), attrs, 2, 2)
    with pytest.raises(ValueError, match="gauss_attrs"):
        cc.composite_infer(ts, pg, attrs[:, :7], 2, 2)
    tc, tT = cc.composite_infer(ts, pg, attrs, 2, 2)  # empty ranges, on the CPU
    assert tc.shape == (4, 256, 3) and bool((tT == 1).all()) and float(tc.abs().max()) == 0
    tc, tT, ncon = cc.composite_fwd(ts, pg, attrs, 2, 2)
    assert ncon.dtype == torch.int32 and not ncon.any()
    d = torch.zeros(4, 256, 3)
    with pytest.raises(ValueError, match="n_contrib"):
        cc.composite_bwd(ts, pg, attrs, d, tT, tT, ncon.long(), 2, 2)
    with pytest.raises(ValueError, match="d_tile_colors"):
        cc.composite_bwd(ts, pg, attrs, d[:3], tT, tT, ncon, 2, 2)
    grads = cc.composite_bwd(ts, pg, attrs, d, tT, tT, ncon, 2, 2)
    assert grads.shape == (3, 9) and not grads.any()


def test_gauss_attrs_layout():
    """Rows are mean x/y, conic a/b/c, f16(r)<<16|f16(g), f16(b)<<16|f16(op), 0."""
    m = torch.tensor([[1.5, -2.0]])
    c = torch.tensor([[0.1, 0.2, 0.3]])
    col = torch.tensor([[0.25, 0.5, 1.0]])
    op = torch.tensor([0.75])
    a = cc.pack_gauss_attrs(m, c, col, op)
    assert a.shape == (1, 8) and a.dtype == torch.float32
    bits = a.view(torch.int32)[0].tolist()
    half = {0.25: 0x3400, 0.5: 0x3800, 1.0: 0x3C00, 0.75: 0x3A00}
    assert bits[5] & 0xFFFFFFFF == (half[0.25] << 16) | half[0.5]
    assert bits[6] & 0xFFFFFFFF == (half[1.0] << 16) | half[0.75]
    assert torch.equal(a[0, :5], torch.cat([m[0], c[0]]))
    assert bits[7] == 0


def test_f16_decode_is_gsjax_s_bit_arithmetic():
    """``decode_f16_pair`` (the plain versions' decode; the kernels'
    ``decode_f16`` runs the same bit arithmetic): every normal f16 exactly,
    zeros and denormals (which the packer flushes) as +0, and the inf and
    NaN patterns as the finite values gsjax's Pallas decode gives them."""
    halves = torch.arange(0, 1 << 16, dtype=torch.int32)
    words = (halves << 16 | halves).view(torch.float32)
    hi, lo = cc.decode_f16_pair(words)
    assert torch.equal(hi.view(torch.int32), lo.view(torch.int32))
    f16 = halves.to(torch.int16).view(torch.float16).to(torch.float32)
    em = halves & 0x7FFF
    normal = (em >= 0x400) & (em < 0x7C00)
    assert torch.equal(hi[normal], f16[normal])
    assert not hi[em < 0x400].view(torch.int32).any()  # +0, sign dropped
    assert float(hi[0x7C00]) == 65536.0 and float(hi[0xFC00]) == -65536.0
    assert bool(torch.isfinite(hi).all())
    # round trip through the packer, as the renderer packs colors
    x = torch.tensor([7e4, -1e5, 0.3, 1e-6, 65504.0])
    r, g = cc.decode_f16_pair(cc.pack_f16_pair(x, -x))
    assert r.tolist() == [65536.0, -65536.0, float(torch.tensor(0.3).half()), 0.0, 65504.0]
    assert g.tolist() == [-65536.0, 65536.0, -float(torch.tensor(0.3).half()), 0.0, -65504.0]


@pytest.mark.cuda
def test_densify_on_the_card_matches_the_plain_cpu_result():
    """The training loop's state surgery on CUDA tensors: clone / split /
    prune (the split noise given), the opacity reset, the optimizer edits
    of ``make_densify_step`` and a train step after them, against the same
    calls on the CPU."""
    import dataclasses

    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.models.densify import DensifyConfig, densify_and_prune, reset_opacity
    from gsjax_torch.models.gaussians import state_from_numpy
    from gsjax_torch.train.optim import adam_moments, make_optimizer
    from gsjax_torch.train.step import TrainConfig, make_densify_step

    dev = _cuda()
    rng = np.random.default_rng(3)
    n, c = 3000, 4096
    means, scales, quats, opac, shs = _scene(n, 5)
    scales[n // 2:] *= 0.1  # below percent_dense * extent (0.03): clones; the rest split
    params = {"xyz": means, "scaling": np.log(scales), "rotation": quats,
              "opacity": np.log(opac / (1 - opac))[:, None], "features_dc": shs[:, :1],
              "features_rest": shs[:, 1:]}
    params = {k: np.concatenate([v, np.zeros((c - n,) + v.shape[1:], np.float32)])
              for k, v in params.items()}
    active = np.arange(c) < n
    denom = np.where(active, rng.integers(1, 5, c), 0).astype(np.float32)
    accum = (rng.uniform(0, 4e-4, c) * denom).astype(np.float32)
    radii = np.where(active, rng.uniform(0, 30, c), 0).astype(np.float32)
    eps = torch.from_numpy(rng.normal(0, 1, (2, c, 3)).astype(np.float32))
    mu = {k: torch.from_numpy(rng.normal(0, 1e-3, v.shape).astype(np.float32))
          for k, v in params.items()}
    nu = {k: torch.from_numpy(rng.uniform(0, 1e-6, v.shape).astype(np.float32))
          for k, v in params.items()}

    def state(d):
        s = state_from_numpy(params, active, 3, device=d)
        return dataclasses.replace(s, max_radii2d=torch.from_numpy(radii).to(d),
                                   xyz_grad_accum=torch.from_numpy(accum).to(d),
                                   denom=torch.from_numpy(denom).to(d))

    out = {}
    for d in ("cpu", dev):
        for screen in (False, True):
            new, m, v, st = densify_and_prune(
                state(d), {k: t.to(d) for k, t in mu.items()},
                {k: t.to(d) for k, t in nu.items()}, None, 3.0, DensifyConfig(),
                use_screen_size=screen, eps=eps.to(d))
            new, m, v = reset_opacity(new, m, v)
            out[str(d), screen] = (new, m, v, st)
    for screen in (False, True):
        (a, am, av, ast), (b, bm, bv, bst) = out["cpu", screen], out[str(dev), screen]
        assert [int(x) for x in ast] == [int(x) for x in bst]
        assert int(ast.num_cloned) > 0 and int(ast.num_split) > 0
        assert torch.equal(a.active, b.active.cpu())
        for k in a.params:
            # exp, log and the child offsets round alike to an ulp or two
            torch.testing.assert_close(b.params[k].cpu(), a.params[k], rtol=1e-6, atol=1e-6)
            assert torch.equal(am[k], bm[k].cpu()) and torch.equal(av[k], bv[k].cpu())

    # make_densify_step on the card: the bound optimizer steps on
    s = state(dev)
    opt = make_optimizer(OptimizationParams(), 1.0).init(s.params)
    densify, reset = make_densify_step(OptimizationParams(), TrainConfig(extent=3.0))
    s, opt, st = densify(s, opt, prng.PRNGKey(0), True)
    s, opt = reset(s, opt)
    assert all(opt.param(k) is s.params[k] for k in s.params)
    for v in s.params.values():
        v.grad = torch.full_like(v, 1e-3)
    opt.step()
    assert bool(torch.isfinite(s.params["xyz"]).all()) and opt.count == 1
    assert all(m.device == s.params["xyz"].device for m in adam_moments(opt)[0].values())


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
@pytest.mark.parametrize("on", [pytest.param("cuda", marks=pytest.mark.cuda), "cpu"])
def test_kernels_on_a_strip_match_the_frame(on, dense):
    """The sharded path's strip (``parallel.shard``): tile rows [2, 5) of a
    6-row frame, the rects clipped to the strip and ``means2d`` moved up by
    its origin, through composite_infer, composite_fwd and the backward, equal
    the same tiles of the whole frame (the backward: with the frame's
    cotangents zero outside the strip). On CPU tensors the plain versions."""
    dev = _cuda() if on == "cuda" else torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain versions beside other test workers
    try:
        _strip_against_frame(dev, dense)
    finally:
        torch.set_num_threads(threads)


def _strip_against_frame(dev, dense):
    from gsjax_torch.ops.binning import key_depth_bits
    from gsjax_torch.parallel.shard import strip_splats

    w, h = 70, 90
    tx, ty = num_tiles(w, h)
    sp = preprocess(*(torch.from_numpy(g).to(dev) for g in _scene(300, 5, dense)),
                    _camera(w, h, dev), 3)

    def kernel_args(splats, rows, y_origin):
        b = build_tile_bins(splats, tx, rows, 1 << 15, max_tiles_per_gauss=16,
                            expansion="compact", depth_bits=key_depth_bits(tx * ty))
        means = splats.means2d - torch.tensor([0.0, y_origin], device=dev)
        return (b.tile_start, b.pair_gauss,
                cc.pack_gauss_attrs(means, splats.conics, splats.colors, splats.opacities),
                tx, rows)

    y0, sy = 2, 3
    frame = kernel_args(sp, ty, 0.0)
    strip = kernel_args(strip_splats(sp, y0, sy), sy, 16.0 * y0)
    rows = slice(y0 * tx, (y0 + sy) * tx)
    for name, fn in (("infer", cc.composite_infer), ("fwd", cc.composite_fwd)):
        whole, part = fn(*frame), fn(*strip)
        assert_two_tier(part[0], whole[0][rows], f"{name} colors")
        assert_two_tier(part[1], whole[1][rows], f"{name} T")
    _, f_T, f_n = cc.composite_fwd(*frame)
    _, s_T, s_n = cc.composite_fwd(*strip)
    assert float((s_n == f_n[rows]).float().mean()) >= 0.999

    g = torch.Generator(device=dev).manual_seed(0)
    d_c = torch.zeros(f_T.shape + (3,), device=dev)
    d_T = torch.zeros_like(f_T)
    d_c[rows] = torch.randn(d_c[rows].shape, generator=g, device=dev)
    d_T[rows] = torch.randn(d_T[rows].shape, generator=g, device=dev)
    whole = cc.composite_grads(*frame[:3], d_c, d_T, f_T, f_n, tx, ty)
    part = cc.composite_grads(*strip[:3], d_c[rows], d_T[rows], s_T, s_n, tx, sy)
    assert float(whole[2].abs().max()) > 0
    for name, got, want in zip(("means2d", "conics", "colors", "opacities"), part, whole):
        assert_norm_tiers(got, want, name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3,), (1001,), (2, 4099, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_prng_draws_on_the_card_equal_the_cpus(shape):
    """gsjax's random keys (``utils.prng``) draw the same bits on the card
    as on the CPU, where tests/test_torch_prng.py holds them to
    ``jax.random``: bits, uniforms and normals bit for bit."""
    dev = _cuda()
    for seed in (0, 1, 2**31 - 1):
        key = prng.fold_in(prng.split(prng.PRNGKey(seed))[1], 7)
        for fn in (prng.bits, prng.uniform, prng.normal):
            got, want = fn(key, shape, dev), fn(key, shape, "cpu")
            assert got.device.type == "cuda"
            if got.dtype == torch.float32:
                got, want = got.view(torch.int32), want.view(torch.int32)
            assert torch.equal(got.cpu(), want), (fn.__name__, seed)


# --------------------------------------------------------------------------
# the captured CUDA graphs of the train step, the chained dispatch and the
# frame (utils.graphs) against the eager path
# --------------------------------------------------------------------------


def _graph_fixture(dev, grad_dtype="float32", n=3000, w=176, h=104):
    from gsjax_torch.bench_scene import bench_camera, toy_state
    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.data.cameras import stack_render_cameras
    from gsjax_torch.train.optim import make_optimizer
    from gsjax_torch.train.step import TrainConfig

    state = toy_state(n, 4096, device=dev)
    cams = stack_render_cameras([bench_camera(w, h, yaw, (0.02 * yaw, 0.0, 0.0))
                                 for yaw in (0.0, 0.01, -0.01)], dev)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)).to(dev)
    cfg = TrainConfig(settings=RasterizeSettings(
        max_pairs=1 << 16, max_tiles_per_gauss=16, expansion="compact",
        grad_dtype=grad_dtype), extent=3.0)
    tx = make_optimizer(OptimizationParams(), 3.0)
    return state, tx.init(state.params), tx, cams, images, cfg


def _run_both(state, opt, graphed, eager, calls):
    """``calls`` (argument tuples) through ``graphed`` from the current
    state, then through ``eager`` from the same state restored: each run's
    metrics and final snapshot."""
    from gsjax_torch.train.step import restore, snapshot

    start = snapshot(state, opt)
    runs = []
    for fn in (graphed, eager):
        restore(state, opt, start)
        ms = [fn(state, opt, *args)[2] for args in calls]
        torch.cuda.synchronize()
        runs.append((ms, snapshot(state, opt)))
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_graphed_step_and_dispatch_equal_eager(grad_dtype):
    """The captured train step (its first call the warm-up, then replays)
    and chained dispatch compute what the eager path computes, bit for bit:
    parameters, Adam's moments and counts, the statistics and the
    metrics."""
    from gsjax_torch.train.step import make_train_step, make_train_step_chained
    from gsjax_torch.train.step import snapshot_differences as _differing

    dev = _cuda()
    state, opt, tx, cams, images, cfg = _graph_fixture(dev, grad_dtype)
    (gm, gs), (em, es) = _run_both(
        state, opt, make_train_step(tx, cams, images, cfg),
        make_train_step(tx, cams, images, cfg, eager=True), [(i % 3,) for i in range(5)])
    assert _differing(gs, es) == []
    for a, b in zip(gm, em):
        assert all(torch.equal(a[k], b[k]) for k in a), (a, b)
    chained = [make_train_step_chained(tx, cams, images, cfg, 4, eager=e) for e in (False, True)]
    (gm, gs), (em, es) = _run_both(state, opt, *chained, [([0, 2, 1, 2],), ([1, 1, 0, 2],)])
    assert _differing(gs, es) == []
    assert all(torch.equal(gm[-1][k], em[-1][k]) for k in gm[-1])
    assert chained[0].graphs.captures == 1


@pytest.mark.cuda
def test_scan_backend_steps_run_eager():
    """The scan backend's backward (torch's cumprod) reads the device, so
    its steps run eager on the card, counted as such, and never capture."""
    import dataclasses

    from gsjax_torch.train.step import STEP_PATHS, make_train_step

    dev = _cuda()
    state, opt, tx, cams, images, cfg = _graph_fixture(dev, n=500, w=64, h=48)
    cfg = dataclasses.replace(cfg, settings=dataclasses.replace(
        cfg.settings, backend="scan", max_splats_per_tile=1024))
    step = make_train_step(tx, cams, images, cfg)
    before = dict(STEP_PATHS)
    for i in range(2):
        state, opt, m = step(state, opt, i)
    assert np.isfinite(float(m["loss"])) and step.graphs.captures == 0
    assert STEP_PATHS["eager"] - before["eager"] == 2


@pytest.mark.cuda
def test_graph_replays_count_their_launches():
    """A capture launches nothing and takes back the counts its Python
    added; each replay adds them again: the counters stay the kernels that
    ran."""
    from gsjax_torch.train.step import make_train_step

    dev = _cuda()
    state, opt, tx, cams, images, cfg = _graph_fixture(dev, "bfloat16")
    step = make_train_step(tx, cams, images, cfg)
    before = (cc.composite_fwd.launches, cc.composite_bwd.launches,
              cc.composite_bwd.launches_bf16, cc.composite_infer.launches)
    for i in range(4):
        state, opt, _ = step(state, opt, i % 3)
    got = (cc.composite_fwd.launches, cc.composite_bwd.launches,
           cc.composite_bwd.launches_bf16, cc.composite_infer.launches)
    assert tuple(g - b for g, b in zip(got, before)) == (4, 4, 4, 0)
    entry = next(iter(step.graphs.entries.values()))[1]
    assert entry[3].replays == 3  # the first call was the warm-up


@pytest.mark.cuda
def test_graphed_dispatch_never_waits_for_the_card():
    """A replayed step and chained dispatch under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync is left."""
    from gsjax_torch.train.step import make_train_step, make_train_step_chained

    dev = _cuda()
    state, opt, tx, cams, images, cfg = _graph_fixture(dev, "bfloat16")
    step = make_train_step(tx, cams, images, cfg)
    chained = make_train_step_chained(tx, cams, images, cfg, 3)
    state, opt, _ = step(state, opt, 0)
    state, opt, _ = chained(state, opt, [0, 1, 2])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, opt, m = step(state, opt, 1)
        state, opt, mc = chained(state, opt, [2, 1, 0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(mc["loss_mean"]))


@pytest.mark.cuda
def test_graphed_frame_equals_eager():
    from gsjax_torch.bench_scene import bench_camera, toy_state
    from gsjax_torch.train.step import TrainConfig, make_render_fn

    dev = _cuda()
    state = toy_state(3000, 4096, device=dev)
    cfg = TrainConfig(settings=RasterizeSettings(max_pairs=1 << 16, expansion="compact"))
    fns = [make_render_fn(cfg, with_stats=True, eager=e) for e in (False, True)]
    before = cc.composite_infer.launches
    for yaw in (0.0, 0.01, -0.01, 0.0):
        rc = bench_camera(176, 104, yaw).to_render_camera(dev)
        bg = torch.tensor([0.1, 0.2, yaw], device=dev)
        (gi, gd), (ei, ed) = (fn(state, rc, bg) for fn in fns)
        assert torch.equal(gi, ei) and torch.equal(gd, ed)
    assert cc.composite_infer.launches - before == 8
    # new parameter tensors (render_bench perturbs xyz every frame) replay
    # the same graph on its own copy of the model
    import dataclasses

    params = dict(state.params)
    params["xyz"] = params["xyz"] + 1e-3
    moved = dataclasses.replace(state, params=params)
    (gi, _), (ei, _) = (fn(moved, rc, bg) for fn in fns)
    assert torch.equal(gi, ei) and fns[0].graphs.captures == 1


@pytest.mark.cuda
def test_capture_refuses_a_host_sync():
    """A function that reads a device value on the host cannot be
    captured: the capture raises (in a process of its own)."""
    import os
    import subprocess
    import sys

    _cuda()
    code = ("import torch\n"
            "from gsjax_torch.utils.graphs import Graph\n"
            "x = torch.ones(4, device='cuda')\n"
            "g = Graph(lambda: x * int(x.sum()), torch.device('cuda'))\n"
            "try:\n"
            "    g()\n"
            "except RuntimeError as e:\n"
            "    print('refused:', str(e).splitlines()[0])\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert "refused:" in res.stdout, (res.stdout, res.stderr[-2000:])
