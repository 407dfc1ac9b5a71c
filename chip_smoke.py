#!/usr/bin/env python
"""On-card smoke test of the gsjax_torch port (one NVIDIA GPU).

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the render path from ``gsjax_torch/csrc``
   (``nvcc`` for sm_90a, into ``build/gsjax_torch/``);
3. kernel against its plain PyTorch version on the 50,000-gaussian 512x512
   scene and on one frame of the 1M-gaussian 1080p scene, with the
   tolerance stated below;
4. the main path: the 1M-gaussian 1080p scene rendered through
   ``make_render_fn`` for 40 frames from 4 camera poses, launch counts
   reset just before and read just after; then per-phase and per-kernel
   times with CUDA events;
5. the offline-render CLI (``gsjax_torch.render``) on a small synthetic
   scene written to a temporary directory;
6. a ``{"kernels": [...]}`` line, the card line, and last the
   ``{"ok": true, "device": ...}`` line.

Imports nothing of JAX or gsjax. Exits nonzero with no result when CUDA is
unavailable or the port's package is missing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain version: the kernel runs the sequential recurrence, the
# plain version the chunked cumulative product (float reassociation), and a
# pair whose alpha sits within an ulp of the 1/255 cut or whose blend sits
# at the T < 1e-4 exit can be taken by one and not the other, which moves
# that pixel by up to about one minimum contribution. Hence two tiers: the
# bulk (p99.9) within 5e-4, every value within 6e-3.
MAX_TOL = 6e-3
P999_TOL = 5e-4

# H100 SXM data-sheet peaks: HBM3 bandwidth and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations per evaluated (pair, pixel): dx, dy (2), the quadratic
# form (11), the exp (1), op * exp (1), the 0.99 clamp (1). The blend of a
# contributing pair adds ~9 more and is not counted, so this is a floor.
OPS_PER_EVAL = 16

BENCH_MAX_PAIRS = 3_538_944
MAIN_FRAMES = 40  # 10 per pose; the 75th percentile has 10 frames beyond it


def log(msg):
    print(msg, flush=True)


def toy_state(n, capacity, seed=0, log_scale=-2.5, device="cuda"):
    """The random scene of the repository's bench entry point: ``n``
    gaussians in [-2, 2]^2 x [4, 10] in front of an identity camera,
    ``log_scale=-5.2`` for footprints of 1-6 tiles at 1080p, SH degree 3.
    Built from a numpy seed, rows in the same order as gsjax's recipe."""
    import torch

    from gsjax_torch.models.gaussians import create_empty

    rng = np.random.default_rng(seed)
    state = create_empty(capacity, device=device)
    p = state.params

    def put(key, arr):
        p[key][:n] = torch.as_tensor(arr.astype(np.float32), device=device)

    put("xyz", np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)],
        axis=1,
    ))
    put("scaling", rng.normal(log_scale, 0.5, (n, 3)))
    put("features_dc", rng.normal(0, 0.5, (n, 1, 3)))
    put("opacity", rng.normal(0, 1, (n, 1)))
    state.active[:n] = True
    state.active_sh_degree = 3
    return state


def bench_camera(width, height, yaw=0.0, shift=(0.0, 0.0, 0.0)):
    """The bench entry point's camera (identity pose, fov_x 0.9), turned by
    ``yaw`` radians about the view's y axis and moved by ``shift``."""
    from gsjax_torch.data.cameras import Camera

    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return Camera(
        uid=0, image_name="bench", R=R, T=np.asarray(shift, np.float64),
        fov_x=0.9, fov_y=0.9 * height / width, width=width, height=height,
    )


def kernel_inputs(state, rcam, settings):
    """The compositing kernel's inputs for one frame of the render path."""
    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.ops.binning import build_tile_bins
    from gsjax_torch.ops.cuda_composite import pack_gauss_attrs
    from gsjax_torch.ops.projection import num_tiles, preprocess

    tiles_x, tiles_y = num_tiles(rcam.width, rcam.height)
    means3d, scales, quats, opac, shs = activated(state)
    sp = preprocess(means3d, scales, quats, opac, shs, rcam, state.active_sh_degree,
                    active_mask=state.active)
    bins = build_tile_bins(
        sp, tiles_x, tiles_y, settings.max_pairs,
        max_tiles_per_gauss=settings.max_tiles_per_gauss,
        tier_frac=settings.tier_frac, expansion=settings.expansion,
    )
    attrs = pack_gauss_attrs(sp.means2d, sp.conics, sp.colors, sp.opacities)
    return (bins.tile_start, bins.pair_gauss, attrs, tiles_x, tiles_y), bins


def compare(name, got, want):
    """max |diff| and p99.9 |diff| of two tensors; raises past the tiers."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output has non-finite values")
    d = (got - want).abs().flatten().sort().values
    mx = float(d[-1])
    p999 = float(d[int(0.999 * (d.numel() - 1))])
    log(f"  {name}: max |diff| {mx:.3e}, p99.9 {p999:.3e}")
    if mx > MAX_TOL or p999 > P999_TOL:
        raise AssertionError(
            f"{name}: kernel and plain version disagree (max {mx:.3e} > {MAX_TOL} "
            f"or p99.9 {p999:.3e} > {P999_TOL})"
        )
    return mx


def time_cuda(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` calls, CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_compare(device):
    """Kernel vs plain version on the 50k-gaussian 512x512 scene (the
    1080p comparison runs in :func:`main_path`, on its inputs)."""
    import torch

    from gsjax_torch.ops.cuda_composite import composite_infer, composite_infer_plain
    from gsjax_torch.ops.rasterize import RasterizeSettings

    log("phase 3: kernel vs plain version")
    worst = 0.0
    state = toy_state(50_000, 65_536, device=device)
    rcam = bench_camera(512, 512).to_render_camera(device)
    settings = RasterizeSettings(max_pairs=1 << 20, max_splats_per_tile=1024, chunk=32)
    with torch.no_grad():
        args, bins = kernel_inputs(state, rcam, settings)
        kc, kT = composite_infer(*args)
        pc, pT = composite_infer_plain(*args)
        torch.cuda.synchronize()
    log(f"  512x512: {int(bins.num_pairs)} pairs, {int(bins.num_dropped)} dropped")
    worst = max(worst, compare("512 tile_colors", kc, pc), compare("512 tile_T", kT, pT))
    return worst


def main_path(device, n=1_000_000, capacity=1 << 20, w=1920, h=1080,
              max_pairs=BENCH_MAX_PAIRS):
    """The 1M-gaussian 1080p scene through make_render_fn; returns the
    kernel's entry of the ``kernels`` line."""
    import torch

    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.ops import cuda_composite
    from gsjax_torch.ops.binning import build_tile_bins
    from gsjax_torch.ops.composite import assemble_image
    from gsjax_torch.ops.cuda_composite import (
        composite_infer, composite_infer_plain, pack_gauss_attrs,
    )
    from gsjax_torch.ops.projection import num_tiles, preprocess
    from gsjax_torch.ops.rasterize import RasterizeSettings
    from gsjax_torch.train.step import TrainConfig, make_render_fn

    log(f"phase 4: main path, {n} gaussians at {w}x{h}")
    state = toy_state(n, capacity, log_scale=-5.2, device=device)
    poses = [(0.0, (0.0, 0.0, 0.0)), (0.01, (0.02, 0.0, 0.0)),
             (-0.01, (-0.02, 0.01, 0.0)), (0.0, (0.0, -0.02, 0.0))]
    rcams = [bench_camera(w, h, yaw, shift).to_render_camera(device)
             for yaw, shift in poses]
    bg = torch.zeros(3, device=device)
    # size the per-gaussian tile cap from the model's footprints, as
    # render.py's budget probe does: the widest gaussians of this scene
    # span more than 16 tiles, and inference must drop nothing
    with torch.no_grad():
        touched = [preprocess(*activated(state), rc, 3, active_mask=state.active).tiles_touched
                   for rc in rcams]
    mt_need = max(int(t.max()) for t in touched)
    pairs_need = max(int(t.sum()) for t in touched)
    mt = max(16, 1 << (mt_need - 1).bit_length())
    log(f"  footprint probe: widest gaussian {mt_need} tiles -> max_tiles_per_gauss "
        f"{mt}; pairs needed {pairs_need} of the budget {max_pairs}")
    settings = RasterizeSettings(max_pairs=max_pairs, expansion="compact",
                                 max_tiles_per_gauss=mt)
    render_fn = make_render_fn(TrainConfig(settings=settings), with_stats=True)
    for rc in rcams:  # warm-up, outside the counted run
        render_fn(state, rc, bg)
    torch.cuda.synchronize()

    cuda_composite.composite_infer.launches = 0
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(MAIN_FRAMES)]
    outs = []
    t0 = time.perf_counter()
    for i in range(MAIN_FRAMES):
        ev[i][0].record()
        outs.append(render_fn(state, rcams[i % len(rcams)], bg))
        ev[i][1].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = cuda_composite.composite_infer.launches

    frame_ms = [a.elapsed_time(b) for a, b in ev]
    for i, (img, dropped) in enumerate(outs):
        if int(dropped) != 0:
            raise AssertionError(f"frame {i}: {int(dropped)} pairs dropped")
        if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"frame {i}: bad image {tuple(img.shape)} or non-finite")
    if launches != MAIN_FRAMES:
        raise AssertionError(f"composite_infer launched {launches} times for "
                             f"{MAIN_FRAMES} frames")
    med = statistics.median(frame_ms)
    p75 = statistics.quantiles(frame_ms, n=4)[2]
    log(f"  {MAIN_FRAMES} frames from {len(rcams)} poses, num_dropped 0, finite")
    log(f"  frame ms (CUDA events, n={MAIN_FRAMES}): median {med:.3f}, p75 {p75:.3f}, "
        f"min {min(frame_ms):.3f}, max {max(frame_ms):.3f}; fps {1000.0 / med:.2f}; "
        f"host wall {1000.0 * wall_s / MAIN_FRAMES:.3f} ms/frame")

    # per-phase times of one frame, the same calls as render() makes
    rc = rcams[0]
    tx, ty = num_tiles(w, h)
    with torch.no_grad():
        m, s, q, o, sh = activated(state)
        cache = {}

        def f_pre():
            cache["sp"] = preprocess(m, s, q, o, sh, rc, 3, active_mask=state.active)

        def f_bin():
            cache["bins"] = build_tile_bins(cache["sp"], tx, ty, settings.max_pairs,
                                            max_tiles_per_gauss=mt, expansion="compact")

        def f_pack():
            sp = cache["sp"]
            cache["attrs"] = pack_gauss_attrs(sp.means2d, sp.conics, sp.colors, sp.opacities)

        def f_kernel():
            b = cache["bins"]
            cache["out"] = composite_infer(b.tile_start, b.pair_gauss, cache["attrs"], tx, ty)

        def f_asm():
            assemble_image(*cache["out"], bg, tx, ty, w, h)

        phases = {}
        for name, fn, reps in (("preprocess", f_pre, 10), ("binning", f_bin, 10),
                               ("pack", f_pack, 10), ("kernel", f_kernel, 20),
                               ("assemble", f_asm, 10)):
            phases[name] = time_cuda(fn, reps)
        log("  phase ms: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

        # kernel vs plain version at the main path's shapes
        b = cache["bins"]
        args = (b.tile_start, b.pair_gauss, cache["attrs"], tx, ty)
        kc, kT = cache["out"]
        t0 = time.perf_counter()
        pc, pT, n_eval = composite_infer_plain(*args, return_evals=True)
        torch.cuda.synchronize()
        log(f"  plain version, first call: {1000 * (time.perf_counter() - t0):.1f} ms")
        err = max(compare("1080p tile_colors", kc, pc), compare("1080p tile_T", kT, pT))
        plain_ms = time_cuda(lambda: composite_infer_plain(*args), 2)

    n_pairs = int(b.num_pairs)
    evals = int(n_eval.sum())
    p = int(b.pair_gauss.numel())
    n_tiles = tx * ty
    bytes_moved = (cache["attrs"].numel() * 4 + p * 4 + (n_tiles + 1) * 4
                   + n_tiles * 256 * 4 * 4)
    ops = evals * OPS_PER_EVAL
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    log(f"  pairs {n_pairs} (budget {p}), (pair, pixel) evaluations {evals} "
        f"(walk without early exit: {256 * n_pairs})")
    log(f"  kernel bound: {bytes_moved} bytes -> {t_bytes:.4f} ms, {ops} float32 ops "
        f"-> {t_ops:.4f} ms")
    return {
        "name": "composite_infer",
        "route": "cuda",
        "source": "gsjax_torch/csrc/composite_infer.cu",
        "replaces": "gsjax/ops/pallas_composite.py:561",
        "launches": launches,
        "max_abs_err": err,
        "ms": phases["kernel"],
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


def phase_cli(device):
    """gsjax_torch.render on a tiny Blender-format scene + trained model."""
    from PIL import Image

    from gsjax_torch import render as render_cli
    from gsjax_torch.configs import ModelParams, save_cfg_args
    from gsjax_torch.models.gaussians import save_gaussian_ply

    log("phase 5: gsjax_torch.render CLI")
    with tempfile.TemporaryDirectory() as tmp:
        scene, model = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
        os.makedirs(os.path.join(scene, "train"))
        frames = []
        for i in range(2):
            Image.fromarray(np.full((64, 64, 3), 40 * (i + 1), np.uint8)).save(
                os.path.join(scene, "train", f"r_{i}.png"))
            c2w = np.eye(4)
            c2w[:3, 3] = (0.3 * i, 0.0, 4.0)  # OpenGL camera looking down -z
            frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(scene, "transforms_train.json"), "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
        state = toy_state(300, 512, log_scale=-2.5, device=device)
        state.params["xyz"][:, 2] -= 7.0  # around the world origin
        ply_dir = os.path.join(model, "point_cloud", "iteration_7")
        os.makedirs(ply_dir)
        save_gaussian_ply(state, os.path.join(ply_dir, "point_cloud.ply"))
        save_cfg_args(model, ModelParams(source_path=scene, model_path=model))
        stdout = sys.stdout
        try:
            dropped = render_cli.main(["-m", model, "--quiet", "--device", device])
        finally:
            sys.stdout = stdout  # safe_state wraps stdout
        out = os.path.join(model, "train", "ours_7", "renders")
        pngs = sorted(os.listdir(out))
        if pngs != ["00000.png", "00001.png"] or dropped:
            raise AssertionError(f"CLI wrote {pngs}, dropped {dropped}")
        img = np.asarray(Image.open(os.path.join(out, pngs[0])))
        log(f"  wrote {pngs} ({img.shape}, mean {img.mean():.2f})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from gsjax_torch.ops import cuda_composite
    except ImportError as e:
        print(f"chip_smoke: the gsjax_torch package is missing ({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1: card {smi}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    cuda_composite.load_library(verbose=True)
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    device = "cuda"
    err512 = phase_compare(device)
    entry = main_path(device)
    entry["max_abs_err"] = max(entry["max_abs_err"], err512)
    phase_cli(device)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
