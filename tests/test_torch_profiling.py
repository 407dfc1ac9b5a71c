"""The measurement path of gsjax_torch on the CPU: ``utils/profiling``'s
work counts against gsjax's and an independent count, its refusal to time
anything but a card, the bench's and the probes' entry points without a
card, and the bench's on-card cross-check run on CPU tensors."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_camera, make_test_gaussians
from gsjax.ops.binning import build_tile_bins as j_bins
from gsjax.ops.projection import num_tiles
from gsjax.ops.projection import preprocess as j_preprocess
from gsjax_torch.ops import RasterizeSettings as TSettings
from gsjax_torch.ops import cuda_composite as cc
from gsjax_torch.utils import profiling as prof
from test_torch_render import t_camera

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gaussians(n, seed, dense=False):
    kw = dict(spread=0.6, z_range=(3.0, 4.0)) if dense else {}
    gs = make_test_gaussians(n, np.random.default_rng(seed), **kw)
    if dense:
        gs[3][:] = np.random.default_rng(seed).uniform(0.6, 0.99, n)
    return gs


@pytest.mark.parametrize("kw", [{}, dict(max_tiles_per_gauss=8, max_pairs=600)],
                         ids=["default", "capped"])
def test_frame_stats_match_gsjax(kw):
    """``frame_inputs``' ``tile_start`` and ``num_pairs`` — what
    ``roofline_report`` reads — equal gsjax's ``frame_stats``
    (``gsjax/utils/profiling.py:153-165``)."""
    cam = make_test_camera(80, 48, seed=3)
    gs = _gaussians(200, 5)
    settings = TSettings(**kw)
    tx, ty = num_tiles(80, 48)
    rc = cam.to_render_camera()

    @jax.jit
    def frame_stats(*g):
        sp = j_preprocess(*g, rc, 3)
        b = j_bins(sp, tx, ty, settings.max_pairs,
                   max_tiles_per_gauss=settings.max_tiles_per_gauss)
        return b.tile_start, b.num_pairs

    j_ts, j_np = frame_stats(*map(jnp.asarray, gs))
    (tile_start, pair_gauss, attrs, tx2, ty2), bins = prof.frame_inputs(
        *map(torch.from_numpy, gs), t_camera(cam), settings)
    assert (tx2, ty2) == (tx, ty)
    assert np.array_equal(tile_start.numpy(), np.asarray(j_ts))
    assert int(bins.num_pairs) == int(j_np)
    if kw:
        assert int(bins.num_dropped) > 0  # the capped case loses pairs
    assert attrs.shape == (200, 8) and pair_gauss.dtype == torch.int32


def _sequential_evals(tile_start, pair_gauss, attrs, tx, ty):
    """(pair, pixel) evaluations of the kernels' walk, counted pair by pair
    in numpy float32: every pair up to and including the one whose blend
    would take T below 1e-4."""
    means, conics, _, opac = (x.numpy() for x in cc.unpack_gauss_attrs(attrs))
    ts, pg = tile_start.numpy(), pair_gauss.numpy()
    p = np.arange(256)
    total = 0
    for t in range(tx * ty):
        x = ((t % tx) * 16 + p % 16).astype(np.float32)
        y = ((t // tx) * 16 + p // 16).astype(np.float32)
        T = np.ones(256, np.float32)
        done = np.zeros(256, bool)
        for i in range(ts[t], ts[t + 1]):
            total += int((~done).sum())
            g = pg[i]
            dx, dy = x - means[g, 0], y - means[g, 1]
            a, b, c = conics[g]
            power = np.float32(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = np.minimum(np.float32(0.99), opac[g] * np.exp(power))
            ok = ~done & (power <= 0) & (alpha >= np.float32(1 / 255))
            test_T = T * (np.float32(1) - alpha)
            trip = ok & (test_T < np.float32(1e-4))
            T = np.where(ok & ~trip, test_T, T)
            done |= trip
    return total


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "saturating"])
def test_eval_count(dense):
    """``fwd_work``'s evaluations equal the plain kernels' ``return_evals``
    count and a pair-by-pair count of the walk; the saturating scene stops
    early. ``composite_work`` prices the forward's walk and blends."""
    cam = make_test_camera(48, 32, seed=1)
    gs = _gaussians(120, 2, dense)
    args, bins = prof.frame_inputs(*map(torch.from_numpy, gs), t_camera(cam),
                                   TSettings(max_pairs=1 << 14))
    fw = prof.fwd_work(*args)
    n = fw["evals"]
    assert n == int(cc.composite_infer_plain(*args, return_evals=True)[2].sum())
    assert n == _sequential_evals(*args)
    walk_all = 256 * int(bins.num_pairs)
    assert (n < walk_all) if dense else (n == walk_all)
    work = prof.composite_work(args[1], args[2], args[3], args[4], 32 * fw["steps_walked"],
                               fw["blends"], bwd_walk=n, bwd_contrib=n // 2)
    assert set(work) == {"composite_infer", "composite_fwd", "composite_bwd"}
    assert work["composite_infer"][1] == work["composite_fwd"][1] == (
        32 * fw["steps_walked"] * prof.OPS_FWD_TEST + fw["blends"] * prof.OPS_FWD_BLEND)
    assert 0 < fw["steps_blend"] <= fw["steps_walked"] <= fw["steps_exit_bound"]
    assert fw["blends"] <= 32 * fw["steps_blend"] and n <= 32 * fw["steps_exit_bound"]
    assert work["composite_fwd"][0] == work["composite_infer"][0] + 6 * 256 * 4
    assert work["composite_bwd"][1] == n * prof.OPS_BWD_WALK + n // 2 * prof.OPS_BWD_CONTRIB


def test_bound_ms():
    assert prof.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert prof.bound_ms(0, 67e9) == (1.0, "operations")
    ms, by = prof.bound_ms(3.35e9, 2 * 67e9)
    assert by == "operations" and abs(ms - 2.0) < 1e-12


def test_timing_refuses_the_cpu():
    gs = [torch.from_numpy(g) for g in _gaussians(20, 0)]
    cam = t_camera(make_test_camera(32, 32))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        prof.timed(lambda eps: None, device="cpu")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        prof.measure_rtt("cpu")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        prof.phase_timings(*gs, cam, TSettings())
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        prof.roofline_report(*gs, cam, TSettings())


def test_roofline_divides_by_the_kernel_time(monkeypatch):
    """``roofline_report`` divides the kernel's counted work by the
    kernel's own event time, whatever the ``composite_ms`` phase (a
    difference of host-bound prefixes, which a busy host drives negative)
    says. Run on CPU tensors with the card-only timing replaced."""
    gs = [torch.from_numpy(g) for g in _gaussians(120, 2)]
    cam = t_camera(make_test_camera(48, 32, seed=1))
    settings = TSettings(max_pairs=1 << 14)
    timed_fns = []

    def fake_timed(fn, reps=3, device="cuda"):
        timed_fns.append(fn)
        fn(0.0)
        return 2e-3

    monkeypatch.setattr(prof, "_require_cuda", torch.device)
    monkeypatch.setattr(prof, "phase_timings", lambda *a, **k: {"composite_ms": -0.7})
    monkeypatch.setattr(prof, "timed", fake_timed)
    roof = prof.roofline_report(*gs, cam, settings)
    args, bins = prof.frame_inputs(*gs, cam, settings)
    fw = prof.fwd_work(*args)
    hbm_bytes, flops = prof.composite_work(args[1], args[2], args[3], args[4],
                                           32 * fw["steps_walked"],
                                           fw["blends"])["composite_infer"]
    assert len(timed_fns) == 1 and roof["composite_ms"] == -0.7
    assert roof["composite_kernel_ms"] == 2.0 and roof["pairs"] == int(bins.num_pairs)
    assert roof["compute_roofline_frac"] == pytest.approx(flops / 2e-3 / prof.PEAK_F32_PER_S)
    assert roof["hbm_roofline_frac"] == pytest.approx(hbm_bytes / 2e-3 / prof.PEAK_BYTES_PER_S)


def test_trace_on_the_cpu(tmp_path):
    """``trace`` writes a Chrome trace; with no device activity
    ``device_summary`` says so (None) instead of inventing a share."""
    with prof.trace(str(tmp_path)) as p:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert prof.device_summary(p) is None


@pytest.mark.parametrize("module", ["gsjax_torch.bench", "gsjax_torch.probes"])
def test_measurement_entry_points_refuse_without_cuda(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", module], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA is not available" in res.stderr


def test_bench_cross_check_on_cpu_tensors():
    """The bench's cross-check on CPU tensors, where the kernel backend is
    the kernels' plain versions: its asserts pass."""
    from gsjax_torch.bench import backend_cross_check
    from gsjax_torch.bench_scene import toy_scene

    state, cam = toy_scene(2000, 4096, 64, 64, log_scale=-4.0, device="cpu")
    from gsjax_torch.bench import XCHECK_BEYOND_MAX

    d, beyond = backend_cross_check(state, cam.to_render_camera("cpu"), torch.zeros(3))
    assert 0.0 <= d <= 6e-3
    assert set(beyond) == {"img", "T"} and max(beyond.values()) <= XCHECK_BEYOND_MAX
