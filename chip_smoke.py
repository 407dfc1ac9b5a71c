#!/usr/bin/env python
"""On-card smoke test of the gsjax_torch port (one NVIDIA GPU).

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``gsjax_torch/csrc`` (one ``nvcc`` per
   source for sm_90a, side by side, into ``build/gsjax_torch/``);
3. each kernel against its plain PyTorch version on the 50,000-gaussian
   512x512 scene and on one frame of the 1M-gaussian 1080p scene, with the
   tolerances stated below; ``composite_fwd``'s image against
   ``composite_infer``'s (bit for bit); two backward runs bit-identical;
4. the render path: the 1M-gaussian 1080p scene rendered through
   ``make_render_fn`` for 40 frames from 4 camera poses, launch counts
   reset just before and read just after; then per-phase and per-kernel
   times with CUDA events;
5. the training path: 24 steps of ``make_train_step`` on the same scene at
   full width (targets: the scene with its base color shifted, rendered
   from the 4 poses), launch counts reset just before and read just after;
   step times and one step's per-phase times with CUDA events;
6. one train step through the kernel backend against one through the
   differentiable scan backend on a 20,000-gaussian 256x256 scene;
7. the offline-render CLI (``gsjax_torch.render``) on a small synthetic
   scene written to a temporary directory;
8. a ``{"kernels": [...]}`` line, the card line, and last the
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
# Backward kernel vs plain version, each output normalised by its max
# |value|: sums over 256 pixels reassociate, and an ulp-level 1/255 cut
# decision (the pixel set comes from the forward's n_contrib) can move a
# pair's gradients by a whole contribution. Measured on an NVIDIA H100
# 80GB HBM3 (700 W) at the bench frame: max 5.6e-5, p99.9 1.6e-7; the
# scan-backend step: max 2.6e-4, p99.9 1.2e-6. Tiers: max 1e-3, p99.9 1e-5
# (tightened from 2e-2 / 1e-3).
GRAD_MAX_TOL = 1e-3
GRAD_P999_TOL = 1e-5
# One Adam step moves a parameter by about its lr whatever the gradient's
# size (a gradient near zero can flip sign between two backends and move it
# by 2 lr), so the kernel and scan backends' updates are held to the bulk:
# p99.9 of |difference| / lr (measured 4.8e-5).
UPDATE_P999_TOL = 1e-3
NCON_AGREE = 0.999  # n_contrib equal to the plain version's on >= 99.9% of pixels

# H100 SXM data-sheet peaks: HBM3 bandwidth and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations per evaluated (pair, pixel): dx, dy (2), the quadratic
# form (11), the exp (1), op * exp (1), the 0.99 clamp (1). The blend of a
# contributing pair adds ~9 more and is not counted, so this is a floor.
OPS_PER_EVAL = 16
# Backward: every (pair, pixel) up to the pixel's n_contrib needs dx, dy and
# the quadratic form (13); a contributing one adds the exp, alpha, T
# rebuilt by a division, w, c.V (5), dL/dalpha (5), S (2), g_pow (2), the
# nine pixel-sum terms and their nine adds (~40). A floor again.
OPS_BWD_WALK = 13
OPS_BWD_CONTRIB = 40

BENCH_MAX_PAIRS = 3_538_944
MAIN_FRAMES = 40  # 10 per pose; the 75th percentile has 10 frames beyond it
TRAIN_STEPS = 24  # 6 per pose
POSES = [(0.0, (0.0, 0.0, 0.0)), (0.01, (0.02, 0.0, 0.0)),
         (-0.01, (-0.02, 0.01, 0.0)), (0.0, (0.0, -0.02, 0.0))]


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


def compare_grads(name, got, want):
    """Normalised by max |want|: p99.9 and max of |got - want|; raises past
    the gradient tiers."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output has non-finite values")
    scale = float(want.abs().max())
    if scale == 0.0:
        raise AssertionError(f"{name}: the plain version's gradients are all zero")
    d = ((got - want).abs() / scale).flatten().sort().values
    mx = float(d[-1])
    p999 = float(d[int(0.999 * (d.numel() - 1))])
    log(f"  {name}: normalised max |diff| {mx:.3e}, p99.9 {p999:.3e} (scale {scale:.3e})")
    if mx > GRAD_MAX_TOL or p999 > GRAD_P999_TOL:
        raise AssertionError(
            f"{name}: kernel and plain version disagree (max {mx:.3e} > {GRAD_MAX_TOL} "
            f"or p99.9 {p999:.3e} > {GRAD_P999_TOL})")
    return mx


GRAD_NAMES = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "opacity", "r", "g", "b")


def check_train_kernels(tag, args):
    """composite_fwd and composite_bwd (with the reduction) against their
    plain versions on one frame's inputs ``args``; composite_fwd's image
    against composite_infer's; two backward runs bit-identical. Returns
    ``(fwd max err, bwd max normalised err, the backward's inputs,
    contributing evaluations)``."""
    import torch

    from gsjax_torch.ops.cuda_composite import (
        composite_bwd, composite_bwd_plain, composite_fwd, composite_fwd_plain,
        composite_grads, composite_infer, reduce_pair_grads,
    )

    tile_start, pair_gauss, attrs, tx, ty = args
    kc, kT, kn = composite_fwd(*args)
    ic, iT = composite_infer(*args)
    pc, pT, pn = composite_fwd_plain(*args)
    torch.cuda.synchronize()
    err_f = max(compare(f"{tag} fwd tile_colors", kc, pc), compare(f"{tag} fwd tile_T", kT, pT))
    if not (torch.equal(kc, ic) and torch.equal(kT, iT)):
        raise AssertionError(f"{tag}: composite_fwd's image differs from composite_infer's")
    agree = float((kn == pn).float().mean())
    log(f"  {tag} composite_fwd == composite_infer bit for bit; n_contrib equal on "
        f"{100 * agree:.4f}% of pixels (max {int(kn.max())})")
    if agree < NCON_AGREE:
        raise AssertionError(f"{tag}: n_contrib agrees on only {agree:.5f} of pixels")

    g = torch.Generator(device=kc.device).manual_seed(0)
    bwd = (tile_start, pair_gauss, attrs, torch.randn(kc.shape, generator=g, device=kc.device),
           torch.randn(kT.shape, generator=g, device=kc.device), kT, kn, tx, ty)
    kg = composite_bwd(*bwd)
    pg, n_live = composite_bwd_plain(*bwd, return_evals=True)
    torch.cuda.synchronize()
    err_b = max(compare_grads(f"{tag} bwd pair {nm}", kg[:, i], pg[:, i])
                for i, nm in enumerate(GRAD_NAMES))
    n = attrs.shape[0]
    kr = reduce_pair_grads(kg, pair_gauss, tile_start, n)
    pr = reduce_pair_grads(pg, pair_gauss, tile_start, n)
    err_b = max(err_b, max(compare_grads(f"{tag} bwd per-gaussian {nm}", kr[:, i], pr[:, i])
                           for i, nm in enumerate(GRAD_NAMES)))
    runs = [composite_grads(*bwd) for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"{tag}: two backward runs differ")
    log(f"  {tag} two backward runs: per-gaussian gradients bit-identical")
    return err_f, err_b, bwd, int(n_live.sum())


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
    with torch.no_grad():
        err_f, err_b, _, _ = check_train_kernels("512", args)
    return worst, err_f, err_b


def main_path(device, n=1_000_000, capacity=1 << 20, w=1920, h=1080,
              max_pairs=BENCH_MAX_PAIRS):
    """The 1M-gaussian 1080p scene through make_render_fn, and the three
    kernels against their plain versions on its first frame. Returns the
    kernels' entries of the ``kernels`` line (launches of the training
    kernels are filled in by :func:`train_path`), the scene, its cameras
    and settings."""
    import torch

    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.ops import cuda_composite
    from gsjax_torch.ops.binning import build_tile_bins
    from gsjax_torch.ops.composite import assemble_image
    from gsjax_torch.ops.cuda_composite import (
        composite_bwd, composite_bwd_plain, composite_fwd, composite_fwd_plain,
        composite_infer, composite_infer_plain, pack_gauss_attrs, reduce_pair_grads,
    )
    from gsjax_torch.ops.projection import num_tiles, preprocess
    from gsjax_torch.ops.rasterize import RasterizeSettings
    from gsjax_torch.train.step import TrainConfig, make_render_fn

    log(f"phase 4: main path, {n} gaussians at {w}x{h}")
    state = toy_state(n, capacity, log_scale=-5.2, device=device)
    rcams = [bench_camera(w, h, yaw, shift).to_render_camera(device)
             for yaw, shift in POSES]
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

        # the training kernels against their plain versions, and their times
        err_f, err_b, bwd, n_live = check_train_kernels("1080p", args)
        fwd_ms = time_cuda(lambda: composite_fwd(*args), 20)
        fwd_plain_ms = time_cuda(lambda: composite_fwd_plain(*args), 2)
        bwd_ms = time_cuda(lambda: composite_bwd(*bwd), 20)
        bwd_plain_ms = time_cuda(lambda: composite_bwd_plain(*bwd), 1)
        pair_grads = composite_bwd(*bwd)
        reduce_ms = time_cuda(lambda: reduce_pair_grads(
            pair_grads, b.pair_gauss, b.tile_start, cache["attrs"].shape[0]), 10)
    log(f"  composite_fwd {fwd_ms:.3f} ms (plain {fwd_plain_ms:.1f}); composite_bwd "
        f"{bwd_ms:.3f} ms (plain {bwd_plain_ms:.1f}); reduction to gaussians "
        f"{reduce_ms:.3f} ms")

    n_pairs = int(b.num_pairs)
    evals = int(n_eval.sum())
    walk = int(bwd[6].to(torch.int64).sum())
    p = int(b.pair_gauss.numel())
    n_tiles = tx * ty
    common = cache["attrs"].numel() * 4 + p * 4 + (n_tiles + 1) * 4
    px_bytes = n_tiles * 256 * 4
    log(f"  pairs {n_pairs} (budget {p}), (pair, pixel) evaluations {evals} "
        f"(walk without early exit: {256 * n_pairs}); backward walk {walk}, "
        f"contributing {n_live}")

    def entry(name, replaces, launches_, err_, ms, plain, bytes_moved, ops):
        t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_PER_S * 1e3
        log(f"  {name} bound: {bytes_moved} bytes -> {t_bytes:.4f} ms, {ops} float32 ops "
            f"-> {t_ops:.4f} ms")
        return {
            "name": name,
            "route": "cuda",
            "source": f"gsjax_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches_,
            "max_abs_err": err_,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,  # no single PyTorch call computes these
        }

    entries = [
        # in: gaussian table, pair_gauss, tile_start; out: rgb + T (+ n_contrib)
        entry("composite_infer", "gsjax/ops/pallas_composite.py:561", launches, err,
              phases["kernel"], plain_ms, common + px_bytes * 4, evals * OPS_PER_EVAL),
        entry("composite_fwd", "gsjax/ops/pallas_composite.py:396", 0, err_f, fwd_ms,
              fwd_plain_ms, common + px_bytes * 5, evals * OPS_PER_EVAL),
        # in: also d_colors, d_T, final_T, n_contrib per pixel; out: (P, 9)
        entry("composite_bwd", "gsjax/ops/pallas_composite.py:754", 0, err_b, bwd_ms,
              bwd_plain_ms, common + px_bytes * 6 + p * 9 * 4,
              walk * OPS_BWD_WALK + n_live * OPS_BWD_CONTRIB),
    ]
    return entries, state, rcams, settings


def shifted_targets(state, rcams, cfg, device):
    """uint8 targets: ``state`` with features_dc shifted by +0.3, rendered
    from ``rcams`` through make_render_fn (inference path)."""
    import dataclasses

    import torch

    from gsjax_torch.train.step import make_render_fn

    params = dict(state.params)
    params["features_dc"] = params["features_dc"].detach() + 0.3
    shifted = dataclasses.replace(state, params=params)
    render_fn = make_render_fn(cfg, with_stats=True, as_uint8=True)
    imgs = []
    for rc in rcams:
        img, dropped = render_fn(shifted, rc, torch.zeros(3, device=device))
        if int(dropped) != 0:
            raise AssertionError(f"target render dropped {int(dropped)} pairs")
        imgs.append(img)
    return torch.stack(imgs)


def step_phases(state, opt, rcam, gt, cfg):
    """One train step's work, staged so CUDA events can split it: preprocess
    and binning, the forward kernel (with the pack), the loss forward and
    backward, the backward kernel, the reduction, autograd through
    preprocess and the activations, Adam. The same calls as the step, minus
    the densification statistics. Returns ms per phase."""
    import torch

    from gsjax_torch.ops.binning import build_tile_bins
    from gsjax_torch.ops.composite import assemble_image
    from gsjax_torch.ops.cuda_composite import (
        composite_bwd, composite_fwd, pack_gauss_attrs, reduce_pair_grads,
    )
    from gsjax_torch.ops.projection import num_tiles, preprocess
    from gsjax_torch.train.loss import l1_loss, ssim
    from gsjax_torch.train.step import _activated_from

    s = cfg.settings
    tx, ty = num_tiles(rcam.width, rcam.height)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    opt.zero_grad(set_to_none=True)
    marks[0].record()
    offset = torch.zeros((state.capacity, 2), device=gt.device, requires_grad=True)
    sp = preprocess(*_activated_from(state.params), rcam, state.active_sh_degree,
                    active_mask=state.active, means2d_offset=offset)
    bins = build_tile_bins(sp, tx, ty, s.max_pairs, max_tiles_per_gauss=s.max_tiles_per_gauss,
                           tier_frac=s.tier_frac, expansion=s.expansion)
    marks[1].record()
    blend = (sp.means2d, sp.conics, sp.colors, sp.opacities)
    attrs = pack_gauss_attrs(*(t.detach() for t in blend))
    tc, tT, ncon = composite_fwd(bins.tile_start, bins.pair_gauss, attrs, tx, ty)
    marks[2].record()
    tc.requires_grad_(True)
    tT.requires_grad_(True)
    img, _ = assemble_image(tc, tT, torch.zeros(3, device=gt.device), tx, ty,
                            rcam.width, rcam.height)
    loss = (1.0 - cfg.lambda_dssim) * l1_loss(img, gt) + cfg.lambda_dssim * (1.0 - ssim(img, gt))
    d_tc, d_tT = torch.autograd.grad(loss, [tc, tT])
    marks[3].record()
    pair_grads = composite_bwd(bins.tile_start, bins.pair_gauss, attrs, d_tc, d_tT, tT.detach(),
                               ncon, tx, ty)
    marks[4].record()
    per = reduce_pair_grads(pair_grads, bins.pair_gauss, bins.tile_start, attrs.shape[0])
    marks[5].record()
    torch.autograd.backward(list(blend), [per[:, 0:2], per[:, 2:5], per[:, 6:9], per[:, 5]])
    marks[6].record()
    opt.step()
    marks[7].record()
    torch.cuda.synchronize()
    opt.zero_grad(set_to_none=True)
    names = ("preprocess+binning", "forward kernel", "loss fwd+bwd", "backward kernel",
             "reduction", "autograd through preprocess", "Adam")
    return {nm: marks[i].elapsed_time(marks[i + 1]) for i, nm in enumerate(names)}


def train_path(device, state, rcams, settings):
    """The training path at full width: 24 steps of make_train_step on the
    bench scene. Returns the launch counts of (composite_infer,
    composite_fwd, composite_bwd) in the counted run."""
    import torch

    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.data.cameras import stack_render_cameras
    from gsjax_torch.ops import cuda_composite as cc
    from gsjax_torch.train.optim import make_optimizer
    from gsjax_torch.train.step import TrainConfig, make_train_step

    w, h = rcams[0].width, rcams[0].height
    log(f"phase 5: training path, {TRAIN_STEPS} steps of make_train_step, "
        f"{int(state.num_active)} gaussians at {w}x{h}")
    cfg = TrainConfig(settings=settings, extent=3.0)
    images = shifted_targets(state, rcams, cfg, device)
    tx = make_optimizer(OptimizationParams(), 3.0)
    opt = tx.init(state.params)
    step = make_train_step(tx, stack_render_cameras(rcams), images, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    cc.composite_infer.launches = cc.composite_fwd.launches = cc.composite_bwd.launches = 0
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(TRAIN_STEPS)]
    metrics = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        ev[i][0].record()
        state, opt, m = step(state, opt, i % len(rcams))
        ev[i][1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = (cc.composite_infer.launches, cc.composite_fwd.launches,
                cc.composite_bwd.launches)

    losses = [float(m["loss"]) for m in metrics]
    dropped = [int(m["num_dropped_pairs"]) for m in metrics]
    step_ms = [a.elapsed_time(b) for a, b in ev]
    if any(dropped):
        raise AssertionError(f"pairs dropped in training steps: {dropped}")
    if not all(bool(torch.isfinite(v).all()) for v in state.params.values()):
        raise AssertionError("non-finite parameters after training")
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    if not last < first:
        raise AssertionError(f"loss did not fall: first 4 {first:.6f}, last 4 {last:.6f}")
    if launches != (0, TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"launches (infer, fwd, bwd) {launches}, want "
                             f"(0, {TRAIN_STEPS}, {TRAIN_STEPS})")
    log(f"  {TRAIN_STEPS} steps from {len(rcams)} poses: num_dropped 0, finite params; "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f} (mean of first 4 {first:.6f}, last 4 "
        f"{last:.6f}); launches infer/fwd/bwd {launches}")
    log(f"  step ms (CUDA events, n={TRAIN_STEPS}): median {statistics.median(step_ms):.3f}, "
        f"p75 {statistics.quantiles(step_ms, n=4)[2]:.3f}, min {min(step_ms):.3f}, "
        f"max {max(step_ms):.3f}; host wall {1000.0 * wall_s / TRAIN_STEPS:.3f} ms/step; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    gt = images[0].to(torch.float32) / 255.0
    for _ in range(2):  # the second is reported
        phases = step_phases(state, opt, rcams[0], gt, cfg)
    log("  one step's phases, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
        + f"; sum {sum(phases.values()):.3f}")
    return launches


def phase_scan_vs_kernel(device, n=20_000, capacity=32_768, size=256):
    """One make_train_step through the kernel backend and one through the
    differentiable scan backend from the same state: loss, gradients (the
    first Adam moment, 0.1 x the gradient) and parameter updates."""
    import torch

    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.ops.rasterize import RasterizeSettings
    from gsjax_torch.train.optim import adam_moments, make_optimizer
    from gsjax_torch.train.step import TrainConfig, make_train_step

    log(f"phase 6: one train step, kernel backend against the scan backend "
        f"({n} gaussians at {size}x{size})")
    rcam = bench_camera(size, size).to_render_camera(device)
    probe = RasterizeSettings(max_pairs=1 << 20, expansion="compact", max_tiles_per_gauss=64)
    state0 = toy_state(n, capacity, seed=1, log_scale=-3.0, device=device)
    with torch.no_grad():
        _, bins = kernel_inputs(state0, rcam, probe)
    longest = int((bins.tile_start[1:] - bins.tile_start[:-1]).max())
    mspt = 32 * -(-longest // 32)
    images = shifted_targets(state0, [rcam], TrainConfig(settings=probe), device)
    res = {}
    for backend in ("kernel", "scan"):
        state = toy_state(n, capacity, seed=1, log_scale=-3.0, device=device)
        settings = RasterizeSettings(max_pairs=1 << 20, expansion="compact",
                                     max_tiles_per_gauss=64, max_splats_per_tile=mspt,
                                     backend=backend)
        tx = make_optimizer(OptimizationParams(), 3.0)
        opt = tx.init(state.params)
        step = make_train_step(tx, [rcam], images, TrainConfig(settings=settings, extent=3.0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, opt, m = step(state, opt, 0)
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0)
        if int(m["num_dropped_pairs"]) or int(m["num_tile_capped"]):
            raise AssertionError(f"{backend}: pairs dropped or capped")
        mu, _ = adam_moments(opt)
        lrs = {g["name"]: g["lr"] for g in opt.param_groups}
        res[backend] = (float(m["loss"]), {k: v.detach() for k, v in state.params.items()},
                        mu, lrs)
        log(f"  {backend}: loss {float(m['loss']):.7f}, {ms:.1f} ms, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (deepest tile {longest} "
            f"pairs, scan cap {mspt})")
    (lk, pk, mk, lrs), (ls, ps, ms_, _) = res["kernel"], res["scan"]
    if abs(lk - ls) > 1e-4 * abs(ls):
        raise AssertionError(f"loss: kernel {lk} vs scan {ls}")
    err = 0.0
    p0 = toy_state(n, capacity, seed=1, log_scale=-3.0, device=device).params
    for k in pk:
        err = max(err, compare_grads(f"gradient {k}", mk[k], ms_[k]))
        d = ((pk[k] - p0[k]) - (ps[k] - p0[k])).abs().flatten().sort().values / lrs[k]
        p999 = float(d[int(0.999 * (d.numel() - 1))])
        log(f"  update {k}: |kernel - scan| / lr p99.9 {p999:.3e}, max {float(d[-1]):.3e}")
        if p999 > UPDATE_P999_TOL:
            raise AssertionError(f"update {k}: p99.9 {p999:.3e} > {UPDATE_P999_TOL}")
    return err


def phase_cli(device):
    """gsjax_torch.render on a tiny Blender-format scene + trained model."""
    from PIL import Image

    from gsjax_torch import render as render_cli
    from gsjax_torch.configs import ModelParams, save_cfg_args
    from gsjax_torch.models.gaussians import save_gaussian_ply

    log("phase 7: gsjax_torch.render CLI")
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
    errs512 = phase_compare(device)
    entries, state, rcams, settings = main_path(device)
    launches = train_path(device, state, rcams, settings)
    for entry, err512, n_launch in zip(entries, errs512, (None,) + launches[1:]):
        entry["max_abs_err"] = max(entry["max_abs_err"], err512)
        if n_launch is not None:
            entry["launches"] = n_launch
    del state
    phase_scan_vs_kernel(device)
    phase_cli(device)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
