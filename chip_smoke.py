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
   ``composite_infer``'s, and both against the forward's check instance,
   its walk without the per-warp cull (``composite_fwd_check``: colors, T
   and ``n_contrib``, bit for bit), with the forward's warp-level work
   (``profiling.fwd_work``); two backward runs bit-identical;
   the backward's check instances (``composite_bwd_counts``): each
   pixel's count of contributing pairs against the plain version's, and
   with the per-warp cull against without it (equal on every pixel, the
   tables bit for bit), and at 1080p the backward's warp-level work
   (``profiling.bwd_work``);
4. the render path: the 1M-gaussian 1080p scene rendered through
   ``make_render_fn`` for 40 frames from 4 camera poses, launch counts
   reset just before and read just after; then per-phase and per-kernel
   times with CUDA events;
5. the training path: 24 steps of ``make_train_step`` on the same scene at
   full width (targets: the scene with its base color shifted, rendered
   from the 4 poses), launch counts reset just before and read just after;
   step times and one step's per-phase times with CUDA events;
   then ``profiling.trace`` (``torch.profiler``) around 4 more steps: the
   top kernels by device time and the device's busy share of the window;
6. one train step through the kernel backend against one through the
   differentiable scan backend on a 20,000-gaussian 256x256 scene;
7. the offline-render CLI (``gsjax_torch.render``) on a small synthetic
   scene written to a temporary directory;
8. the speed-of-light probe (``sol_probe``) against its plain version at
   the 512x512 and the 1080p frame's ``tile_start``, for every swept
   (k_ops, k_exp), the exp instances also under the check coefficients
   (``cuda_probe.check_exp_coefs``: under the probes' own an exp pass
   forgets its input); its times, and the exp passes' times linear in
   their count; then the measurement path as a user
   runs it: ``python -m gsjax_torch.probes --stages
   gather,sort,phases,bwdsplit,bwdcull,fwdcull,vpu,vpux --out`` (the probe path: its
   launch counts come from its last line);
9. ``python -m gsjax_torch.bench --roofline``: a positive frame rate, a
   passed cross-check and no dropped pair;
10. a training run as a user runs it (logged as phase 11), each step
    a subprocess:
    ``python -m gsjax_torch.synthetic_scene`` writes the 250,000-gaussian,
    120-view scene at 1296x840 (30,000 sparse points, seed 0); ``python -m
    gsjax_torch.train -s <scene> --eval`` trains it 600 iterations through
    densification (at 200 and 300: from 100, every 100, until 400), a
    capacity growth (the capacity starts just above the sparse count), an
    opacity reset at 300, evaluations at 300 and 600 and a checkpoint at
    300; a second run
    resumes from ``chkpnt300.npz`` for 100 iterations; ``python -m
    gsjax_torch.render`` renders the test views of the snapshot and
    ``python -m gsjax_torch.metrics`` scores them. It fails unless every
    run exits 0, the log shows clones, splits, a capacity growth and the
    reset (the checkpoint's opacities), the test PSNR at 600 beats 300's,
    the last logged step dropped no pair, ``composite_fwd`` and
    ``composite_bwd`` launched once per step and ``composite_infer`` once
    per evaluated view (each run's counts are reset at its start and
    printed on its last line). It prints it/s, the wall time, the growth
    pause and the peak memory. Its runs pass ``--disable_viewer``;
11. the serving surfaces (logged as phase 12), on the trained model of the
    run before and on the 1M-gaussian bench scene: LPIPS with the
    committed structure-test weights (``evidence/lpips_vgg_structure_
    test.npz``, full VGG16 widths) on the card against the CPU on a
    256x256 crop of a test render and its ground truth, of an image to
    itself, TF32 off, ms per 1296x840 view, then ``python -m
    gsjax_torch.metrics`` with the weights (a finite LPIPS for every
    method and view); the SIBR bridge in process with a scripted client
    (three 1920x1080 frames, bit for bit ``make_render_fn(as_uint8=True)``'s,
    no pair dropped, one ``composite_infer`` launch each); the local viewer
    in process (``/info``, 60 orbit frames at 1920x1080 over HTTP, p50 /
    p90 latency, none dropping a pair, one launch each, and its cached
    function's frame bit for bit a direct render's under the same probed
    settings); then ``python -m gsjax_torch.render_bench --at_1080p
    --views 8`` (exits 0, no pair dropped) and ``python -m
    gsjax_torch.viewer_bench`` at 1920x1080 on the trained model;
12. the sharded path (logged as phase 13), each rank a process started
    through the port's launcher (``parallel.multihost.spawn_ranks``) with a
    timeout: (13a) two ranks sharing the card over gloo, the 1M-gaussian
    1080p scene at phases 4-5's budgets with the grid expansion — on each
    rank's strip (its bins, the gathered splats, ``means2d`` moved up by the
    strip's origin) composite_infer, composite_fwd and composite_bwd against
    their plain versions as in phase 3, the sharded render of the 4 poses
    against make_render_fn (max |diff| <= 3e-5) and, under the compact
    expansion, within SHARD_TIE_SHARE of the pixels, 4 steps of
    make_sharded_train_step against 4 of make_train_step (loss and l1, the
    first step's gradients, every parameter, the accumulated screen-space
    gradient, denom and max_radii2d; see the tolerances below), one step
    through the a2a exchange (nothing dropped, the same loss) and a data=2
    step (the loss the mean of the two cameras'), composite_infer once per
    rank per frame and composite_fwd / composite_bwd once per rank per step;
    (13b) the same steps on one rank over NCCL, its first step bit for bit
    the single-device step's at every stage (``grad_chain``); (13c) ``python
    -m gsjax_torch.train --gauss_shards 2`` on two ranks on the scene of
    phase 11, stopped at 300 iterations: test PSNR and the counts after each
    densification against phase 11's run at 300, the kernels once per rank
    per step; (13d) ``python -m gsjax_torch.train_multiscene`` with that
    scene under two model paths on two ranks, 100 iterations: finite losses,
    the two snapshots equal; (13e) ``python -m gsjax_torch.scaling_bench``
    at gauss 1 (NCCL) and 2 (gloo), with its shared-card note;
13. a ``{"kernels": [...]}`` line (``composite_infer``'s
    ``launches_serving``: the bridge's and the viewer's launches; rows 1-3's
    ``launches_sharded``: 13a's counted launches over both ranks, and
    ``max_abs_err_sharded``: their error on a rank's strip), the
    card line, and last the ``{"ok": true, "device": ...}`` line.

Imports nothing of JAX or gsjax. Exits nonzero with no result when CUDA is
unavailable or the port's package is missing.
"""

from __future__ import annotations

import contextlib
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
# The backward's per-pixel count of contributing pairs: equal to the plain
# version's on >= NCON_AGREE of pixels (expf against torch.exp at the 1/255
# cut), totals within 1e-4 relative, and sum |kernel - plain| over all
# pixels at most COUNT_DIFF_MAX. Measured on an NVIDIA H100 80GB HBM3
# (700 W): 0 at 512x512, 2 pixels at the bench frame (totals equal); the
# limit is about 10x that. A cull or an early exit that loses
# contributions at a gaussian's 1/255 edge passes the gradient tiers, whose
# scale is the largest gradient; it fails this (tests/test_torch_bwd_counts.py:
# a 3-sigma cull loses 3-6% of the contributions of the test scenes). The
# counts with the cull must equal those without it on every pixel: the
# same card arithmetic, so any difference is a lost contribution.
COUNT_TOTAL_RTOL = 1e-4
COUNT_DIFF_MAX = 32
# sol_probe vs its plain version, relative: nvcc contracts x * a + b into
# one FMA where torch rounds twice, and the 128 lanes are summed in another
# order. Measured on an NVIDIA H100 80GB HBM3 (700 W): 1.9e-6 at the 1080p
# frame; the tolerance is about 10x that. Under the check coefficients a
# pass too few or a wrong chunk moves a tile by more than 100x the
# tolerance (tests/test_torch_probes.py).
PROBE_RTOL = 2e-5
# (ms(20, 10) - ms(20, 0)) / (2 (ms(20, 5) - ms(20, 0))): 1 when each exp
# pass costs the same (measured 1.024 on an NVIDIA H100 80GB HBM3, 700 W)
EXP_LINEAR_TOL = 0.1
SUBPROCESS_TIMEOUT_S = 600
# The sharded path against the single-device one, gsjax's tolerances
# (tests/test_parallel.py:55 and :76-96): the image; loss and l1; every
# parameter after the steps; the accumulated screen-space gradient; denom
# and max_radii2d equal.
SHARD_IMG_ATOL = 3e-5
SHARD_LOSS_RTOL = 1e-5
SHARD_PARAM_TOL = (2e-5, 1e-3)  # (atol, rtol)
SHARD_ACCUM_TOL = (1e-4, 1e-3)
SHARD_STEPS = 4
# One rank (13b) sums every gradient as the single-device step does: its
# first step is held bit for bit at every stage (chip_smoke.grad_chain) and
# its parameters to SHARD_PARAM_TOL with nothing allowed beyond. Two ranks
# (13a) reassociate a gaussian's gradient (each strip sums its pairs, the
# all-gather's backward adds the strips), and an Adam step moves a
# parameter by about its lr whatever the gradient's size, so a gradient at
# rounding level can take opposite signs in the two paths. Such elements
# may pass SHARD_PARAM_TOL if they are at most SHARD_FLIP_SHARE of a
# parameter's elements and each within SHARD_FLIP_LR lr over the steps.
# Measured on an NVIDIA H100 80GB HBM3, 700 W, after 4 steps: 1 of the
# 3,145,728 features_dc elements (0.37 lr), 15 of the 47,185,920
# features_rest (0.38 lr), 3 of the 4,194,304 rotation elements (0.57 lr):
# a share of at most 7.2e-7. The limits are about 14x and 3.5x that.
SHARD_FLIP_SHARE = 1e-5
SHARD_FLIP_LR = 2.0
# The sharded render under the compact expansion (the default) against the
# single-device one: the compact sort breaks ties of equal depth keys by a
# count partition that a strip's clipped counts reorder, which moves a
# pixel where two such pairs overlap by a whole blend. At most this share
# of the pixels may be off by more than SHARD_IMG_ATOL. Measured on an
# NVIDIA H100 80GB HBM3, 700 W, at bench1080: 1,725-2,383 of 2,073,600
# pixels a pose (at most 1.15e-3, max |diff| 0.042); the limit is about
# 4x that.
SHARD_TIE_SHARE = 5e-3
SHARD_TIMEOUT_S = 600
# the sharded training run against the single-rank one at the same
# iteration: test PSNR within 0.3 dB, the count after each densification
# within 1% (float reassociation can flip a threshold decision)
SHARD_PSNR_DB = 0.3
SHARD_COUNT_REL = 0.01
# LPIPS on the card against the CPU, relative: two float32 convolution
# libraries (cuDNN with TF32 off, oneDNN) sum 4,608-term dot products in
# other orders
LPIPS_RTOL = 1e-4

BENCH_MAX_PAIRS = 3_538_944
MAIN_FRAMES = 40  # 10 per pose; the 75th percentile has 10 frames beyond it
TRAIN_STEPS = 24  # 6 per pose
TRACE_STEPS = 4
POSES = [(0.0, (0.0, 0.0, 0.0)), (0.01, (0.02, 0.0, 0.0)),
         (-0.01, (-0.02, 0.01, 0.0)), (0.0, (0.0, -0.02, 0.0))]


def log(msg):
    print(msg, flush=True)


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
    against composite_infer's, and both against the forward's walk without
    the cull (colors, T, n_contrib); two backward runs bit-identical; the
    backward's per-pixel contributing counts against the plain version's,
    and with the cull against without it.
    Returns ``(fwd max err, bwd max normalised err, the backward's inputs,
    contributing evaluations, the plain version's backward warp-level
    counts, the forward's warp-level work)``."""
    import torch

    from gsjax_torch.ops.cuda_composite import (
        composite_bwd, composite_bwd_counts, composite_bwd_plain, composite_fwd,
        composite_fwd_check, composite_fwd_plain, composite_grads, composite_infer,
        reduce_pair_grads,
    )
    from gsjax_torch.utils.profiling import fwd_work

    tile_start, pair_gauss, attrs, tx, ty = args
    kc, kT, kn = composite_fwd(*args)
    ic, iT = composite_infer(*args)
    xc, xT, xn = composite_fwd_check(*args)
    pc, pT, pn = composite_fwd_plain(*args)
    torch.cuda.synchronize()
    err_f = max(compare(f"{tag} fwd tile_colors", kc, pc), compare(f"{tag} fwd tile_T", kT, pT))
    if not (torch.equal(kc, ic) and torch.equal(kT, iT)):
        raise AssertionError(f"{tag}: composite_fwd's image differs from composite_infer's")
    if not (torch.equal(kc, xc) and torch.equal(kT, xT) and torch.equal(kn, xn)):
        off = (kc != xc).any(-1) | (kT != xT) | (kn != xn)
        raise AssertionError(f"{tag}: the forward's per-warp cull changed {int(off.sum())} "
                             f"pixels (n_contrib lower on {int((kn < xn).sum())})")
    agree = float((kn == pn).float().mean())
    log(f"  {tag} composite_fwd == composite_infer == the walk without the cull "
        f"(composite_fwd_check), bit for bit; n_contrib equal to the plain version's on "
        f"{100 * agree:.4f}% of pixels (max {int(kn.max())})")
    if agree < NCON_AGREE:
        raise AssertionError(f"{tag}: n_contrib agrees on only {agree:.5f} of pixels")
    fw = fwd_work(*args)
    log(f"  {tag} forward warp-level work: {json.dumps(fw)}")

    g = torch.Generator(device=kc.device).manual_seed(0)
    bwd = (tile_start, pair_gauss, attrs, torch.randn(kc.shape, generator=g, device=kc.device),
           torch.randn(kT.shape, generator=g, device=kc.device), kT, kn, tx, ty)
    kg = composite_bwd(*bwd)
    pg, n_live, stats = composite_bwd_plain(*bwd, return_evals=True)
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

    cg, counts = composite_bwd_counts(*bwd)
    ng, n_counts = composite_bwd_counts(*bwd, cull=False)
    torch.cuda.synchronize()
    if not (torch.equal(cg, kg) and torch.equal(ng, kg)):
        raise AssertionError(f"{tag}: a check instance's table differs from composite_bwd's")
    if not torch.equal(counts, n_counts):
        lost = int((n_counts - counts).long().sum())
        raise AssertionError(f"{tag}: the per-warp cull lost {lost} contributions on "
                             f"{int((counts != n_counts).sum())} pixels")
    diff = (counts.long() - n_live).abs()
    agree = float((diff == 0).float().mean())
    got, want = int(counts.long().sum()), int(n_live.sum())
    rel = abs(got - want) / max(want, 1)
    log(f"  {tag} bwd contributing pairs per pixel: equal to the plain version's on "
        f"{100 * agree:.4f}% of pixels ({int((diff > 0).sum())} differ, sum |diff| "
        f"{int(diff.sum())}); total {got} (plain {want}, {rel:.3e} relative); with the cull "
        f"equal to without it on every pixel, tables bit for bit")
    if agree < NCON_AGREE or rel > COUNT_TOTAL_RTOL or int(diff.sum()) > COUNT_DIFF_MAX:
        raise AssertionError(f"{tag}: the backward's contributing counts disagree (equal on "
                             f"{agree:.5f} of pixels, sum |diff| {int(diff.sum())}, totals "
                             f"{rel:.3e} relative)")
    return err_f, err_b, bwd, want, stats, fw


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
    1080p comparison runs in :func:`main_path`, on its inputs). Returns the
    three kernels' largest errors and the frame's ``tile_start``."""
    import torch

    from gsjax_torch.bench_scene import bench_camera, toy_state
    from gsjax_torch.ops.cuda_composite import composite_infer, composite_infer_plain
    from gsjax_torch.ops.rasterize import RasterizeSettings
    from gsjax_torch.utils.profiling import state_frame_inputs

    log("phase 3: kernel vs plain version")
    worst = 0.0
    state = toy_state(50_000, 65_536, device=device)
    rcam = bench_camera(512, 512).to_render_camera(device)
    settings = RasterizeSettings(max_pairs=1 << 20, max_splats_per_tile=1024, chunk=32)
    with torch.no_grad():
        args, bins = state_frame_inputs(state, rcam, settings)
        kc, kT = composite_infer(*args)
        pc, pT = composite_infer_plain(*args)
        torch.cuda.synchronize()
    log(f"  512x512: {int(bins.num_pairs)} pairs, {int(bins.num_dropped)} dropped")
    worst = max(worst, compare("512 tile_colors", kc, pc), compare("512 tile_T", kT, pT))
    with torch.no_grad():
        err_f, err_b, *_ = check_train_kernels("512", args)
    return (worst, err_f, err_b), bins.tile_start


def bench_scene(device, n, capacity, w, h):
    """The bench scene (``bench_scene.toy_state``, log scale -5.2) and the
    4 poses' render cameras."""
    from gsjax_torch.bench_scene import bench_camera, toy_state

    state = toy_state(n, capacity, log_scale=-5.2, device=device)
    return state, [bench_camera(w, h, yaw, shift).to_render_camera(device)
                   for yaw, shift in POSES]


def bench_settings(state, rcams, max_pairs=BENCH_MAX_PAIRS):
    """The bench scene's budgets: the per-gaussian tile cap sized from the
    model's footprints, as render.py's budget probe does (the widest
    gaussians of this scene span more than 16 tiles, and inference must
    drop nothing), the compact expansion and ``max_pairs``."""
    import torch

    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.ops.projection import preprocess
    from gsjax_torch.ops.rasterize import RasterizeSettings

    with torch.no_grad():
        touched = [preprocess(*activated(state), rc, 3, active_mask=state.active).tiles_touched
                   for rc in rcams]
    mt_need = max(int(t.max()) for t in touched)
    pairs_need = max(int(t.sum()) for t in touched)
    mt = max(16, 1 << (mt_need - 1).bit_length())
    log(f"  footprint probe: widest gaussian {mt_need} tiles -> max_tiles_per_gauss "
        f"{mt}; pairs needed {pairs_need} of the budget {max_pairs}")
    return RasterizeSettings(max_pairs=max_pairs, expansion="compact", max_tiles_per_gauss=mt)


def main_path(device, n=1_000_000, capacity=1 << 20, w=1920, h=1080,
              max_pairs=BENCH_MAX_PAIRS):
    """The 1M-gaussian 1080p scene through make_render_fn, and the three
    kernels against their plain versions on its first frame. Returns the
    kernels' entries of the ``kernels`` line (launches of the training
    kernels are filled in by :func:`train_path`), the scene, its cameras
    and settings, and the first frame's ``tile_start``."""
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
    from gsjax_torch.train.step import TrainConfig, make_render_fn
    from gsjax_torch.utils.profiling import bwd_work, composite_work

    log(f"phase 4: main path, {n} gaussians at {w}x{h}")
    state, rcams = bench_scene(device, n, capacity, w, h)
    bg = torch.zeros(3, device=device)
    settings = bench_settings(state, rcams, max_pairs)
    mt = settings.max_tiles_per_gauss
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
        pc, pT = composite_infer_plain(*args)
        torch.cuda.synchronize()
        log(f"  plain version, first call: {1000 * (time.perf_counter() - t0):.1f} ms")
        err = max(compare("1080p tile_colors", kc, pc), compare("1080p tile_T", kT, pT))
        plain_ms = time_cuda(lambda: composite_infer_plain(*args), 2)

        # the training kernels against their plain versions, and their times
        err_f, err_b, bwd, n_live, bwd_stats, fw = check_train_kernels("1080p", args)
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
    fwd_walk = 32 * fw["steps_walked"]  # what the forward's per-warp cull leaves
    walk = 32 * bwd_stats["steps_walked"]  # what the backward's per-warp cull leaves
    log(f"  pairs {n_pairs} (budget {b.pair_gauss.numel()}), forward (pair, pixel) "
        f"evaluations {fw['evals']} to each pixel's exit (walk without early exit: "
        f"{256 * n_pairs}), {fwd_walk} after the cull, blends {fw['blends']}; backward walk "
        f"{int(bwd[6].to(torch.int64).sum())} to n_contrib, {walk} after the cull, "
        f"contributing {n_live}")
    log(f"  backward warp-level work: {json.dumps(bwd_work(bwd_stats))}")
    work = composite_work(b.pair_gauss, cache["attrs"], tx, ty, fwd_walk, fw["blends"],
                          walk, n_live)
    entries = [
        entry(name, f"gsjax/ops/pallas_composite.py:{line}", launches_, err_, ms, plain,
              *work[name])
        for name, line, launches_, err_, ms, plain in (
            ("composite_infer", 561, launches, err, phases["kernel"], plain_ms),
            ("composite_fwd", 396, 0, err_f, fwd_ms, fwd_plain_ms),
            ("composite_bwd", 754, 0, err_b, bwd_ms, bwd_plain_ms),
        )
    ]
    return entries, state, rcams, settings, b.tile_start


def entry(name, replaces, launches, err, ms, plain_ms, bytes_moved, ops, library_ms=None):
    """One kernel's entry of the ``kernels`` line; its bound from the bytes
    and operations of this run's inputs (``profiling.bound_ms``)."""
    from gsjax_torch.utils.profiling import bound_ms

    bound, by = bound_ms(bytes_moved, ops)
    log(f"  {name} bound: {bytes_moved} bytes, {ops} float32 ops -> {bound:.4f} ms ({by})")
    return {
        "name": name,
        "route": "cuda",
        "source": f"gsjax_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": library_ms,  # no single PyTorch call computes these kernels
    }


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
    bench scene, one step split in phases, and a trace of 4 more. Returns
    the launch counts of (composite_infer, composite_fwd, composite_bwd) in
    the counted run."""
    import torch

    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.data.cameras import stack_render_cameras
    from gsjax_torch.ops import cuda_composite as cc
    from gsjax_torch.train.optim import make_optimizer
    from gsjax_torch.train.step import TrainConfig, make_train_step
    from gsjax_torch.utils.profiling import device_summary, trace

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

    # torch.profiler over a few more steps: kernels by device time, and the
    # share of the window in which the device was busy
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            for i in range(TRACE_STEPS):
                state, opt, _ = step(state, opt, i % len(rcams))
            torch.cuda.synchronize()
        summary = device_summary(prof)
    if summary is None:
        log("  device time: not measured (torch.profiler recorded none)")
    else:
        log(f"  trace of {TRACE_STEPS} steps: device busy {summary['busy_ms']:.3f} ms of a "
            f"{summary['window_ms']:.3f} ms window, busy share {summary['busy_share']:.4f}")
        for name, ms, calls in summary["top"]:
            log(f"    {ms:9.3f} ms  {calls:6d} calls  {name[:100]}")
    return launches


def phase_scan_vs_kernel(device, n=20_000, capacity=32_768, size=256):
    """One make_train_step through the kernel backend and one through the
    differentiable scan backend from the same state: loss, gradients (the
    first Adam moment, 0.1 x the gradient) and parameter updates."""
    import torch

    from gsjax_torch.bench_scene import bench_camera, toy_state
    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.ops.rasterize import RasterizeSettings
    from gsjax_torch.train.optim import adam_moments, make_optimizer
    from gsjax_torch.train.step import TrainConfig, make_train_step
    from gsjax_torch.utils.profiling import state_frame_inputs

    log(f"phase 6: one train step, kernel backend against the scan backend "
        f"({n} gaussians at {size}x{size})")
    rcam = bench_camera(size, size).to_render_camera(device)
    probe = RasterizeSettings(max_pairs=1 << 20, expansion="compact", max_tiles_per_gauss=64)
    state0 = toy_state(n, capacity, seed=1, log_scale=-3.0, device=device)
    with torch.no_grad():
        _, bins = state_frame_inputs(state0, rcam, probe)
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
    from gsjax_torch.bench_scene import toy_state
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


def phase_probe(tile_starts):
    """``sol_probe`` against its plain version at each frame's
    ``tile_start`` for every swept (k_ops, k_exp), the exp instances under
    both coefficient sets, then its times at the last frame's (the 1080p
    one), whose exp passes must cost alike. Returns ``(max |kernel -
    plain|, {config: (ms, plain ms, bound ms, bound by)})``."""
    import torch

    from gsjax_torch.ops.cuda_probe import (
        PROBE_EXP, SWEPT, check_exp_coefs, sol_probe, sol_probe_inputs, sol_probe_plain,
    )
    from gsjax_torch.utils.profiling import bound_ms, sol_probe_work

    log("phase 8: sol_probe against its plain version")
    worst = 0.0
    for tag, ts in tile_starts.items():
        ts = ts.contiguous()
        table = sol_probe_inputs(ts, seed=0)
        for k in SWEPT:
            coef_sets = [("probe", PROBE_EXP)]
            if k[1]:
                coef_sets.append(("check", check_exp_coefs(k[0])))
            for cname, coefs in coef_sets:
                got = sol_probe(ts, table, *k, coefs)
                want = sol_probe_plain(ts, table, *k, coefs)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"sol_probe {tag} {k} {cname}: non-finite output")
                diff = (got - want).abs()
                rel = float((diff / want.abs().clamp_min(1e-30)).max())
                worst = max(worst, float(diff.max()))
                log(f"  {tag} (k_ops, k_exp) {k}, {cname} coefficients: max |diff| "
                    f"{float(diff.max()):.3e}, max relative {rel:.3e} (out max "
                    f"{float(want.abs().max()):.1f})")
                if rel > PROBE_RTOL:
                    raise AssertionError(f"sol_probe {tag} {k} {cname}: relative error "
                                         f"{rel:.3e} > {PROBE_RTOL}")
    times = {}
    for k in SWEPT:
        ms = time_cuda(lambda: sol_probe(ts, table, *k), 10)
        plain = time_cuda(lambda: sol_probe_plain(ts, table, *k), 2)
        bytes_, ops, elements = sol_probe_work(ts, *k)
        bound, by = bound_ms(bytes_, ops)
        times[k] = (ms, plain, bound, by)
        log(f"  {tag} {k}: kernel {ms:.4f} ms, plain {plain:.3f} ms; {elements} elements, "
            f"{ops} float32 ops, {bytes_} bytes -> bound {bound:.4f} ms ({by})")
    e5, e10 = (times[(20, e)][0] - times[(20, 0)][0] for e in (5, 10))
    ratio = e10 / (2 * e5)
    log(f"  exp passes: 5 take {e5:.4f} ms, 10 take {e10:.4f} ms; linearity {ratio:.4f}")
    if abs(ratio - 1) > EXP_LINEAR_TOL:
        raise AssertionError(f"sol_probe: 10 exp passes take {ratio:.4f} x twice 5's")
    return worst, times


def run_module(phase, args, env=None):
    """``python -m <args>`` from the checkout (with ``env`` added to the
    environment), its output echoed; raises unless it exits 0. Returns its
    standard output's lines."""
    import torch

    torch.cuda.empty_cache()  # the subprocess shares the card
    cmd = [sys.executable, "-m", *args]
    log(f"phase {phase}: {' '.join(cmd[2:])}")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=SUBPROCESS_TIMEOUT_S, env={**os.environ, **(env or {})})
    for line in res.stderr.splitlines()[-40:]:
        log(f"  | {line}")
    lines = res.stdout.splitlines()
    for line in lines:
        log(f"  > {line}")
    log(f"  exit {res.returncode} in {time.perf_counter() - t0:.1f} s")
    if res.returncode != 0:
        raise AssertionError(f"{args[0]} exited {res.returncode}")
    return lines


def phase_probes():
    """The measurement path: gsjax_torch.probes with --out. Returns the
    launch counts of its run (its last line)."""
    lines = run_module(9, ["gsjax_torch.probes", "--stages",
                           "gather,sort,phases,bwdsplit,bwdcull,fwdcull,vpu,vpux", "--out"])
    done = json.loads(lines[-1])
    if done.get("stage") != "done":
        raise AssertionError(f"probes: last line {lines[-1]!r}")
    return done["launches"]


def phase_bench():
    """gsjax_torch.bench --roofline: one JSON line with a positive frame
    rate, a passed cross-check, no dropped pair, a roofline fraction that
    a card can reach and the probes' ceilings."""
    result = json.loads(run_module(10, ["gsjax_torch.bench", "--roofline"])[-1])
    ex = result["extra"]
    checks = {
        "value > 0": (result["value"] or 0) > 0,
        "cross-check passed": isinstance(ex["backend_xcheck_max_diff"], float)
        and ex["backend_xcheck_max_diff"] <= MAX_TOL,
        "num_dropped == 0": ex["num_dropped"] == 0,
        "0 < roofline_frac <= 1": 0 < ex["roofline_frac"] <= 1,
        "roofline_ref from the probes": isinstance(ex["roofline_ref"], dict),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bench: {failed}")
    log(f"  bench: {result['value']} frames/s, fwd+bwd {ex['fwd_bwd_frames_per_s']}, train "
        f"{ex['train_iters_per_s']} it/s, cross-check {ex['backend_xcheck_max_diff']}")


def _train_log(model):
    with open(os.path.join(model, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _train_run(phase, scene, model, device, args):
    """One ``python -m gsjax_torch.train`` run; returns its last line (the
    iterations, launch counts, wall time and peak memory) and its log."""
    lines = run_module(phase, ["gsjax_torch.train", "-s", scene, "-m", model, "--eval",
                               "--device", device, "--disable_viewer", *args])
    done = json.loads(lines[-1])
    if done.get("stage") != "done":
        raise AssertionError(f"train: last line {lines[-1]!r}")
    return done, _train_log(model)


def phase_training_run(device="cuda", width=1296, height=840, scene_args=(),
                          capacity=32_768, iterations=600, resume=100, phase=11, workdir=None):
    """A training run as a user runs it (see the module docstring,
    phase 10); ``device``, the size and ``scene_args`` let it run small on
    the CPU. Its scene and model directories are made in ``workdir`` (a
    temporary directory when None, removed at the end). Returns a summary
    dict of its numbers and the trained model's directory."""
    log(f"phase {phase}: training run at {width}x{height}")
    with contextlib.ExitStack() as stack:
        tmp = workdir or stack.enter_context(tempfile.TemporaryDirectory())
        scene, model, model2 = (os.path.join(tmp, d) for d in ("scene", "model", "resumed"))
        run_module(phase, ["gsjax_torch.synthetic_scene", scene, "--width", str(width),
                           "--height", str(height), "--device", device, *scene_args])
        half = iterations // 2
        # densification ends before the first one after the reset: that one
        # would add the 20-pixel screen-size prune (reference train.py:118-
        # 119), which at this compressed schedule removes the still coarse
        # SfM-initialised model (31,565 of 32,773 gaussians at 400 on an
        # H100), as it would in gsjax and the reference
        schedule = ["--densify_from_iter", str(iterations // 6),
                    "--densification_interval", str(iterations // 6),
                    "--densify_until_iter", str(2 * iterations // 3),
                    "--opacity_reset_interval", str(half)]
        done, records = _train_run(phase, scene, model, device, [
            "--iterations", str(iterations), *schedule,
            "--test_iterations", str(half), str(iterations),
            "--checkpoint_iterations", str(half), "--capacity", str(capacity)])

        dens = [r for r in records if r.get("event") == "densify"]
        grows = [r for r in records if r.get("event") == "capacity_growth"]
        evals = {r["iter"]: r["eval"] for r in records if "eval" in r}
        progress = [r for r in records if "it_per_s" in r]
        cloned, split = sum(r["cloned"] for r in dens), sum(r["split"] for r in dens)
        log(f"  densify events {[(r['iter'], r['cloned'], r['split'], r['pruned'], r['num_active']) for r in dens]} "
            f"(iteration, cloned, split, pruned, active); growths "
            f"{[(r['iter'], r['capacity'], r['pause_s']) for r in grows]} (iteration, "
            f"capacity, pause s)")
        with np.load(os.path.join(model, f"chkpnt{half}.npz")) as ck:
            # leaves 2 and 6: the opacity logits and the active mask
            # (gsjax_torch.train.checkpoint.LEAVES)
            opac = 1.0 / (1.0 + np.exp(-ck["leaf_2"][ck["leaf_6"], 0]))
        psnr = {it: e["test"]["psnr"] for it, e in evals.items()}
        n_eval = sum(e[s]["n_views"] for e in evals.values() for s in ("test", "train"))
        want = {"composite_fwd": iterations, "composite_bwd": iterations,
                "composite_infer": n_eval}
        log(f"  test PSNR {psnr}; it/s {[(r['iter'], round(r['it_per_s'], 2)) for r in progress]}; "
            f"wall {done['wall_s']:.1f} s; peak memory {done['peak_memory_gib']} GiB; "
            f"{done['num_active']} gaussians (capacity {done['capacity']}); launches "
            f"{done['launches']} (want {want}); max opacity after the reset {opac.max():.5f}")
        checks = {
            "densify events with clones and splits": bool(dens) and cloned > 0 and split > 0,
            "a capacity growth": bool(grows),
            "the opacity reset (every active opacity <= 0.01 in the checkpoint)":
                float(opac.max()) <= 0.01 + 1e-6,
            f"test PSNR at {iterations} beats {half}'s":
                psnr.get(iterations, 0) > psnr.get(half, float("inf")),
            "no pair dropped at the end": progress[-1]["iter"] == iterations
                and progress[-1]["dropped_pairs"] == 0,
            "launches: fwd and bwd once per step, infer once per eval view":
                device != "cuda" or done["launches"] == want,
        }

        # resume from the checkpoint for `resume` iterations
        done2, records2 = _train_run(phase, scene, model2, device, [
            "--iterations", str(half + resume), *schedule,
            "--test_iterations", str(half + resume),
            "--start_checkpoint", os.path.join(model, f"chkpnt{half}.npz")])
        evals2 = [r["eval"] for r in records2 if "eval" in r]
        n_eval2 = sum(e[s]["n_views"] for e in evals2 for s in ("test", "train"))
        want2 = {"composite_fwd": resume, "composite_bwd": resume, "composite_infer": n_eval2}
        log(f"  resumed at {half}: {resume} iterations in {done2['wall_s']:.1f} s, test PSNR "
            f"{[e['test']['psnr'] for e in evals2]}, launches {done2['launches']} (want {want2})")
        checks["the resumed run evaluated"] = len(evals2) == 1
        checks["resumed launches"] = device != "cuda" or done2["launches"] == want2

        # the snapshot through the render and metrics CLIs
        out = run_module(phase, ["gsjax_torch.render", "-m", model, "--skip_train",
                                 "--device", device])
        renders = os.path.join(model, "test", f"ours_{iterations}", "renders")
        n_png = len(os.listdir(renders))
        run_module(phase, ["gsjax_torch.metrics", "-m", model, "--device", device])
        with open(os.path.join(model, "results.json")) as f:
            results = json.load(f)[f"ours_{iterations}"]
        log(f"  render CLI: {n_png} test views; metrics CLI: {results} (training eval "
            f"{psnr.get(iterations)})")
        checks["the render CLI wrote every test view, none darkened"] = (
            n_png == evals[iterations]["test"]["n_views"]
            and not any("WARNING" in line for line in out))
        checks["metrics: PSNR within 0.5 dB of the training eval"] = (
            abs(results["PSNR"] - psnr[iterations]) < 0.5)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"training run: {failed}")
    log(f"  training run: every check passed ({len(checks)})")
    return {"wall_s": done["wall_s"], "it_per_s": progress[-1]["it_per_s"],
            "growth_pause_s": [r["pause_s"] for r in grows],
            "peak_memory_gib": done["peak_memory_gib"], "psnr": psnr, "model": model,
            "scene": scene, "schedule": schedule, "capacity": capacity,
            "densify": {r["iter"]: r["num_active"] for r in dens}}


def sibr_message(cam, scaling_modifier=1.0, shs_python=False, train=True):
    """The wire message a SIBR remote viewer sends for the host-side camera
    ``cam``: the bridge's transform inverted (column-vector -> row-vector
    matrices, the Y/Z column flips)."""
    wv = np.asarray(cam.world_view, np.float32).T.copy()
    wv[:, 1] *= -1
    wv[:, 2] *= -1
    fp = np.asarray(cam.full_proj, np.float32).T.copy()
    fp[:, 1] *= -1
    return {"resolution_x": cam.width, "resolution_y": cam.height, "train": train,
            "fov_y": cam.fov_y, "fov_x": cam.fov_x, "z_near": 0.01, "z_far": 100.0,
            "shs_python": shs_python, "rot_scale_python": False, "keep_alive": False,
            "scaling_modifier": scaling_modifier, "view_matrix": wv.flatten().tolist(),
            "view_projection_matrix": fp.flatten().tolist()}


def phase_lpips(device, model, iterations):
    """Phase 12a: LPIPS with the structure-test weights (full VGG16
    widths) on the card against the CPU on a 256x256 crop of one of the
    trained model's test renders and its ground truth; a distance of an
    image to itself; TF32 off; ms per full view; then the metrics CLI with
    the weights, which must write a finite LPIPS for every method and view.
    Returns (ms per view, the CLI's LPIPS)."""
    import torch
    from PIL import Image

    from gsjax_torch.eval.lpips import load_weights, lpips

    log("phase 12a: LPIPS (structure-test weights, full VGG16 widths)")
    weights = os.path.join(HERE, "evidence", "lpips_vgg_structure_test.npz")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: LPIPS would move in its third decimal")
    base = os.path.join(model, "test", f"ours_{iterations}")

    def image(sub):
        path = os.path.join(base, sub, "00000.png")
        return torch.from_numpy(np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0)

    render, gt = image("renders"), image("gt")
    params = load_weights(weights, device)
    h, w = render.shape[:2]  # the center: a corner can be background in both
    crop = (slice(h // 2 - 128, h // 2 + 128), slice(w // 2 - 128, w // 2 + 128))
    card = float(lpips(render[crop].to(device), gt[crop].to(device), params))
    cpu = float(lpips(render[crop], gt[crop], load_weights(weights, "cpu")))
    if cpu <= 0:
        raise AssertionError(f"LPIPS: the crop's render equals its ground truth ({cpu})")
    rel = abs(card - cpu) / cpu
    self_d = float(lpips(render[crop].to(device), render[crop].to(device), params))
    r, g = render.to(device), gt.to(device)
    ms = time_cuda(lambda: lpips(r, g, params), 5)
    log(f"  256x256 center crop: card {card:.7f}, CPU {cpu:.7f}, relative {rel:.3e}; lpips(a, a) "
        f"{self_d:.3e}; {tuple(render.shape[:2])} view {ms:.2f} ms on the card (TF32 off)")
    if not (rel <= LPIPS_RTOL and abs(self_d) <= 1e-6):
        raise AssertionError(f"LPIPS: card vs CPU relative {rel:.3e} > {LPIPS_RTOL} or "
                             f"lpips(a, a) {self_d:.3e}")

    run_module(12, ["gsjax_torch.metrics", "-m", model, "--device", device],
               env={"GSJAX_LPIPS_WEIGHTS": weights})
    with open(os.path.join(model, "results.json")) as f:
        results = json.load(f)
    with open(os.path.join(model, "per_view.json")) as f:
        per_view = json.load(f)
    n_views = len(os.listdir(os.path.join(base, "renders")))
    for method, m in results.items():
        views = per_view[method].get("LPIPS", {})
        if not (np.isfinite(m.get("LPIPS", np.nan)) and len(views) == n_views
                and all(np.isfinite(v) for v in views.values())):
            raise AssertionError(f"metrics CLI: {method} has no finite LPIPS for each of "
                                 f"its {n_views} views: {m}")
    log(f"  metrics CLI: {results} ({n_views} views each)")
    return ms, {k: v["LPIPS"] for k, v in results.items()}


def phase_bridge(state, settings, device, w=1920, h=1080):
    """Phase 12b: the SIBR bridge in process on the bench scene, a scripted
    client on a thread asking for three 1920x1080 frames on one connection
    (scaling_modifier 1.0, 0.5, and the SH python path). Each frame's bytes
    must equal make_render_fn(as_uint8=True)'s for the decoded camera, bit
    for bit, with no pair dropped, and the source path must come back; the
    bridge's renders are composite_infer's launches. Returns (launches,
    ms per frame as the client saw it)."""
    import socket
    import threading

    import torch

    from gsjax_torch.bench_scene import bench_camera
    from gsjax_torch.ops import cuda_composite
    from gsjax_torch.train.step import TrainConfig, make_render_fn
    from gsjax_torch.viewer.network_gui import ViewerBridge, _camera_from_message

    log(f"phase 12b: the SIBR bridge, 3 frames of the bench scene at {w}x{h}")
    cam = bench_camera(w, h)
    msgs = [sibr_message(cam), sibr_message(cam, 0.5), sibr_message(cam, shs_python=True)]
    bridge = ViewerBridge(port=0, source_path="bench1080")
    port = bridge.listener.getsockname()[1]
    replies, times = [], []

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
            f = s.makefile("rb")
            for m in msgs:
                payload = json.dumps(m).encode("utf-8")
                t0 = time.perf_counter()
                s.sendall(len(payload).to_bytes(4, "little") + payload)
                img = f.read(m["resolution_x"] * m["resolution_y"] * 3)
                n = int.from_bytes(f.read(4), "little")
                replies.append((img, f.read(n).decode("ascii")))
                times.append((time.perf_counter() - t0) * 1e3)

    render_fn = make_render_fn(TrainConfig(settings=settings))  # float, as the loop's
    torch.cuda.synchronize()
    cuda_composite.composite_infer.launches = 0
    t = threading.Thread(target=client)
    t.start()
    try:
        for _ in range(2000):
            bridge.poll(1, state, render_fn)  # one frame per poll: train is true
            if not t.is_alive():
                break
            t.join(timeout=0.005)
        t.join(timeout=60)
    finally:
        bridge.close()
    launches = cuda_composite.composite_infer.launches
    u8 = make_render_fn(TrainConfig(settings=settings), with_stats=True, as_uint8=True)
    checks = {"three replies": len(replies) == 3 and not t.is_alive(),
              "launches == frames": launches == len(msgs)}
    for m, (img, path) in zip(msgs, replies):
        rcam = _camera_from_message(m, device)
        want, dropped = u8(state, rcam, torch.zeros(3, device=device), m["scaling_modifier"],
                           shs_python=m["shs_python"])
        got = np.frombuffer(img, np.uint8).reshape(h, w, 3)
        tag = f"scale {m['scaling_modifier']}, shs_python {m['shs_python']}"
        checks[f"{tag}: bit for bit"] = np.array_equal(got, want.cpu().numpy())
        checks[f"{tag}: no pair dropped"] = int(dropped) == 0
        checks[f"{tag}: source path"] = path == "bench1080"
    log(f"  frames {['%.1f' % x for x in times]} ms at the client; composite_infer launches "
        f"{launches}; checks {sum(checks.values())}/{len(checks)}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bridge: {failed}")
    return launches, times


def phase_local_viewer(state, device, frames=60, w=1920, h=1080, n=1_000_000):
    """Phase 12c: the local web viewer in process on the bench scene at
    1920x1080: /info, ``frames`` /render requests orbiting /info's center
    at 2.2x its extent (the page's default), each view's pairs all kept;
    one frame of the viewer's cached function against a direct
    make_render_fn(with_stats=True) under the same probed settings, bit
    for bit. Returns (launches, ms p50, ms p90, JPEG KB mean)."""
    import urllib.request

    import torch

    from gsjax_torch.data.cameras import lookat_camera
    from gsjax_torch.ops import cuda_composite
    from gsjax_torch.train.step import TrainConfig, make_render_fn, quantize
    from gsjax_torch.viewer.local_viewer import LocalViewer

    log(f"phase 12c: the local viewer, {frames} frames of the bench scene at {w}x{h}")
    viewer = LocalViewer(state, np.zeros(3, np.float32), port=0, device=device)
    torch.cuda.synchronize()
    cuda_composite.composite_infer.launches = 0
    base = f"http://127.0.0.1:{viewer.start()}"
    eyes, times, sizes = [], [], []
    try:
        with urllib.request.urlopen(f"{base}/info", timeout=120) as r:
            info = json.loads(r.read())
        c, rad = np.asarray(info["center"]), 2.2 * info["extent"]
        for i in range(frames):
            az, el = 0.6 + 2 * np.pi * i / frames, 0.35
            eye = c + rad * np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el),
                                      np.sin(el)])
            eyes.append(eye)
            q = (f"ex={eye[0]}&ey={eye[1]}&ez={eye[2]}&tx={c[0]}&ty={c[1]}&tz={c[2]}"
                 f"&w={w}&h={h}&scale=1.0")
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"{base}/render?{q}", timeout=300) as r:
                sizes.append(len(r.read()))
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        viewer.stop()
    launches = cuda_composite.composite_infer.launches
    fn = viewer._fn_for(w, h)
    s = fn.settings
    direct = make_render_fn(TrainConfig(settings=s), with_stats=True)
    bg = viewer.bg
    dropped = []
    for eye in eyes:
        rc = lookat_camera(eye, c, (0, 0, 1), 1.1, w, h).to_render_camera(device)
        dropped.append(int(direct(state, rc, bg)[1]))
    rc = lookat_camera(eyes[0], c, (0, 0, 1), 1.1, w, h).to_render_camera(device)
    img, _ = direct(state, rc, bg, 1.0)
    same = torch.equal(fn(state, rc, bg, 1.0), quantize(img))
    p50, p90 = (float(np.percentile(times[3:], q)) for q in (50, 90))
    log(f"  /info {info['n_gaussians']} gaussians, center {np.round(c, 3).tolist()}, extent "
        f"{info['extent']:.3f}; probed settings max_pairs {s.max_pairs}, max_tiles_per_gauss "
        f"{s.max_tiles_per_gauss}, tier_frac {s.tier_frac}, expansion {s.expansion}")
    log(f"  frame latency after 3 warm-up frames: p50 {p50:.1f} ms, p90 {p90:.1f} ms (first "
        f"{times[0]:.0f} ms, with the probe); JPEG {np.mean(sizes) / 1024:.1f} KB; launches "
        f"{launches}; pairs dropped {sum(dropped)}; cached function == direct: {same}")
    checks = {f"{n} gaussians": info["n_gaussians"] == n,
              "launches == frames": launches == frames,
              "no view dropped a pair": sum(dropped) == 0,
              "the cached function's frame bit for bit": same}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"local viewer: {failed}")
    return launches, p50, p90, float(np.mean(sizes)) / 1024


def phase_serving(device, model, iterations, settings):
    """Phase 12: the serving surfaces. LPIPS and the metrics CLI, the SIBR
    bridge and the local viewer in process on the bench scene, then the
    render and viewer benches on the trained model. Returns the launches
    of composite_infer by the bridge and the viewer."""
    from gsjax_torch.bench_scene import toy_state

    t0 = time.perf_counter()
    lpips_ms, _ = phase_lpips(device, model, iterations)
    state = toy_state(1_000_000, 1 << 20, log_scale=-5.2, device=device)
    bridge_launches, _ = phase_bridge(state, settings, device)
    viewer_launches, *_ = phase_local_viewer(state, device)
    del state

    result = json.loads(run_module(12, ["gsjax_torch.render_bench", "-m", model, "--at_1080p",
                                        "--views", "8", "--device", device])[-1])
    if result["extra"]["num_dropped"] != 0 or not result["value"] > 0:
        raise AssertionError(f"render_bench: {result}")
    log(f"  render_bench: {result['value']} frames/s at {result['extra']['resolution']} "
        f"({result['extra']['n_gaussians']} gaussians, max_pairs "
        f"{result['extra']['max_pairs']}, on {result['extra']['device']})")
    lines = run_module(12, ["gsjax_torch.viewer_bench", "-m", model, "--width", "1920",
                            "--height", "1080", "--frames", "60", "--port", "0",
                            "--device", device])
    report = json.loads("\n".join(lines[lines.index("{"):]))
    log(f"  viewer_bench: p50 {report['p50_ms']} ms, p90 {report['p90_ms']} ms, "
        f"{report['fps_mean']} frames/s, JPEG {report['jpeg_kb_mean']} KB")
    log(f"phase 12: {time.perf_counter() - t0:.1f} s; LPIPS {lpips_ms:.2f} ms per view")
    return bridge_launches + viewer_launches


def _clone_state(state):
    import dataclasses

    return dataclasses.replace(
        state, params={k: v.detach().clone() for k, v in state.params.items()},
        active=state.active.clone(), max_radii2d=state.max_radii2d.clone(),
        xyz_grad_accum=state.xyz_grad_accum.clone(), denom=state.denom.clone())


def _close(name, got, want, atol, rtol):
    """max |got - want|; raises unless every element is within atol + rtol |want|."""
    d = (got - want).abs()
    bad = int((d > atol + rtol * want.abs()).sum())
    mx = float(d.max()) if d.numel() else 0.0
    if bad:
        raise AssertionError(f"{name}: {bad} elements beyond atol {atol} + rtol {rtol} "
                             f"(max |diff| {mx:.3e})")
    return mx


def _close_adam(name, got, want, lr):
    """:func:`_close` with SHARD_PARAM_TOL, forgiving the sign-flipped
    Adam updates of rounding-level gradients (see SHARD_FLIP_SHARE)."""
    atol, rtol = SHARD_PARAM_TOL
    d = (got - want).abs()
    off = d > atol + rtol * want.abs()
    n_off, mx = int(off.sum()), float(d.max())
    worst = float(d[off].max()) if n_off else 0.0
    if n_off > SHARD_FLIP_SHARE * d.numel() or worst > SHARD_FLIP_LR * lr:
        raise AssertionError(f"{name}: {n_off} of {d.numel()} elements beyond atol {atol} + "
                             f"rtol {rtol}, the worst {worst:.3e} (lr {lr:.3e})")
    return {"max_abs_diff": mx, "beyond_tol": n_off, "worst_in_lr": worst / lr}


def _tie_diff(img, ref, dropped):
    """The sharded compact render against the single-device one: max
    |diff|, and the pixels beyond SHARD_IMG_ATOL (those where pairs of equal
    depth keys blend in another order); raises past SHARD_TIE_SHARE."""
    d = (img - ref).abs().amax(-1)
    r = {"max_abs_diff": float(d.max()), "pixels_beyond": int((d > SHARD_IMG_ATOL).sum()),
         "pixels": d.numel(), "dropped": dropped}
    beyond = r["pixels_beyond"] > SHARD_TIE_SHARE * d.numel()
    if dropped or beyond or not bool(img.isfinite().all()):
        raise AssertionError(f"compact sharded render against the single-device one: {r}")
    return r


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _bits(a, b):
    """How many elements of two tensors differ, and the largest |difference|."""
    d = (a.double() - b.double()).abs()
    return {"differ": int((a != b).sum()), "max_abs": float(d.max()) if d.numel() else 0.0}


def grad_chain(tx, mesh, cams, images, cfg, state0, cam):
    """One sharded step and one single-device step from ``state0`` on camera
    ``cam``, compared stage by stage bit for bit: the compositing kernels'
    inputs (the splat fields), their image (tile colors), d loss / d image
    (the tile colors' cotangent), the kernels' backward (the splat fields'
    gradients) and the parameters' gradients as Adam receives them."""
    import dataclasses

    from gsjax_torch.ops import rasterize
    from gsjax_torch.parallel import make_sharded_train_step, shard
    from gsjax_torch.parallel.shard import shard_gaussian_state
    from gsjax_torch.train.step import make_train_step

    fields = ("means2d", "conics", "colors", "opacities")
    cfg = dataclasses.replace(cfg, settings=dataclasses.replace(cfg.settings, backend="kernel"))

    def run(module, step, state, cam_arg):
        got, orig = {"d_in": {}}, module.composite

        def wrapped(*args):
            got["in"] = [t.detach().clone() for t in args[:4]]
            for f, t in zip(fields, args[:4]):
                t.register_hook(lambda g, f=f: got["d_in"].__setitem__(f, g.detach().clone()))
            out = orig(*args)
            got["out"] = out[0].detach().clone()
            out[0].register_hook(lambda g: got.__setitem__("d_out", g.detach().clone()))
            return out

        opt = tx.init(state.params)
        adam_step = opt.step

        def step_keeping_grads(*a, **k):
            got["grads"] = {n: v.grad.detach().clone() for n, v in state.params.items()}
            return adam_step(*a, **k)

        opt.step = step_keeping_grads
        module.composite = wrapped
        try:
            step(state, opt, cam_arg)
        finally:
            module.composite = orig
        return got

    sharded = run(shard, make_sharded_train_step(tx, mesh, cams, images, cfg),
                  shard_gaussian_state(state0, mesh), [cam])
    single = run(rasterize, make_train_step(tx, cams, images, cfg), _clone_state(state0), cam)
    report = {f"splat {f}": _bits(a, b) for f, a, b in zip(fields, sharded["in"], single["in"])}
    report["tile colors"] = _bits(sharded["out"], single["out"])
    report["d loss / d tile colors"] = _bits(sharded["d_out"], single["d_out"])
    report.update({f"d {f}": _bits(sharded["d_in"][f], single["d_in"][f]) for f in fields})
    report.update({f"grad {k}": _bits(sharded["grads"][k], single["grads"][k])
                   for k in single["grads"]})
    return report


def sharded_rank(spec):
    """One rank of phase 13a or 13b (``python chip_smoke.py --sharded-rank
    SPEC``): the bench scene through the sharded render and train step at
    ``spec["case"]``'s mesh, held by rank 0 against the single-device path
    on the same inputs. Rank 0 writes the numbers to ``spec["out"]``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.data.cameras import stack_render_cameras
    from gsjax_torch.ops import cuda_composite as cc
    from gsjax_torch.parallel import make_mesh, make_sharded_render, make_sharded_train_step
    from gsjax_torch.parallel.multihost import global_to_host_local, maybe_initialize, rank_device
    from gsjax_torch.parallel.shard import (
        gather_gaussian_state,
        gather_moments,
        shard_gaussian_state,
        strip_kernel_args,
    )
    from gsjax_torch.train.optim import adam_moments, make_optimizer
    from gsjax_torch.train.step import TrainConfig, make_render_fn, make_train_step

    device = spec["device"]
    maybe_initialize(device=device)
    dev = rank_device(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    state0, rcams = bench_scene(dev, spec["n"], spec["capacity"], spec["w"], spec["h"])
    # phases 4-5's budgets with the grid expansion: its sort breaks equal
    # depth keys by gaussian index in a strip as in the frame (the compact
    # expansion's tie-break is a count partition, which a strip's clipped
    # counts reorder; at 1M gaussians equal 19-bit depth keys are common)
    settings = dataclasses.replace(bench_settings(state0, rcams, spec["max_pairs"]),
                                   expansion="grid")
    cfg = TrainConfig(settings=settings, extent=3.0)
    images = shifted_targets(state0, rcams, cfg, dev)
    tx = make_optimizer(OptimizationParams(), 3.0)
    cams = stack_render_cameras(rcams)
    bg = torch.zeros(3, device=dev)
    out = {"rank": rank, "world": world, "backend": dist.get_backend()}
    main = rank == 0
    mesh = make_mesh(data=1, gauss=world, device=device)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, 1e3 * (time.perf_counter() - t0)

    if spec["case"] == "13b" and main:
        out["grad_chain"] = grad_chain(tx, mesh, cams, images, cfg, state0, 0)
        for k, v in out["grad_chain"].items():
            log(f"  first step, sharded against single, {k}: {v}")
        off = [k for k, v in out["grad_chain"].items() if v["differ"]]
        if off:
            raise AssertionError(f"one rank's first step differs from the single-device "
                                 f"step at {off}")

    if spec["case"] == "13a":  # the sharded render of the 4 poses
        render = make_sharded_render(mesh, settings, spec["w"], spec["h"], with_stats=True)
        local = shard_gaussian_state(state0, mesh)
        if cuda:  # the kernels against their plain versions on this rank's strip
            with torch.no_grad():
                err_f, err_b, *_ = check_train_kernels(
                    f"rank {rank} strip", strip_kernel_args(local, rcams[0], settings, mesh))
            out["strip_kernel_err"] = global_to_host_local(
                torch.tensor([err_f, err_b], dtype=torch.float64)).tolist()
        render(local, rcams[0], bg)  # warm-up, outside the counted run
        sync()
        cc.composite_infer.launches = 0
        frames = [timed(lambda rc=rc: render(local, rc, bg)) for rc in rcams]
        out["render_launches"] = global_to_host_local(
            torch.tensor(cc.composite_infer.launches)).tolist()
        out["frame_ms"] = [ms for _, ms in frames]
        out["render_dropped"] = [int(f[2]) for f, _ in frames]
        del local
        if main:
            single = make_render_fn(cfg, with_stats=True)
            errs = []
            for (img, _, _), rc in zip((f for f, _ in frames), rcams):
                ref, dropped = single(state0, rc, bg)
                if int(dropped):
                    raise AssertionError(f"single-device render dropped {int(dropped)} pairs")
                errs.append(float((img - ref).abs().max()))
            out["render_max_abs_diff"] = max(errs)
            if max(errs) > SHARD_IMG_ATOL or any(out["render_dropped"]):
                raise AssertionError(f"sharded render: max |diff| {errs} (atol "
                                     f"{SHARD_IMG_ATOL}), dropped {out['render_dropped']}")
        # the compact expansion (the default): ties in depth order may break
        # otherwise in a strip than in the frame
        compact = dataclasses.replace(settings, expansion="compact")
        render = make_sharded_render(mesh, compact, spec["w"], spec["h"], with_stats=True)
        local = shard_gaussian_state(state0, mesh)
        frames = [render(local, rc, bg) for rc in rcams]
        del local
        if main:
            single = make_render_fn(TrainConfig(settings=compact, extent=3.0), with_stats=True)
            out["compact"] = [_tie_diff(img, single(state0, rc, bg)[0], int(dropped))
                              for (img, _, dropped), rc in zip(frames, rcams)]
            log(f"  compact expansion, sharded against single: {out['compact']}")

    # SHARD_STEPS sharded steps against as many single-device steps
    order = [i % len(rcams) for i in range(SHARD_STEPS)]
    local = shard_gaussian_state(state0, mesh)
    opt = tx.init(local.params)
    step = make_sharded_train_step(tx, mesh, cams, images, cfg)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    cc.composite_infer.launches = cc.composite_fwd.launches = cc.composite_bwd.launches = 0
    ms, step_ms = [], []
    for i, c in enumerate(order):
        (local, opt, m), t = timed(lambda c=c: step(local, opt, [c]))
        ms.append({k: float(v) for k, v in m.items()})
        step_ms.append(t)
        if i == 0:  # the first step's gradients, as 0.1 x in Adam's first moment
            mu_first = gather_moments(opt, mesh)[0]
    out["step_launches"] = global_to_host_local(torch.tensor(
        [cc.composite_infer.launches, cc.composite_fwd.launches, cc.composite_bwd.launches]
    )).tolist()
    out["step_ms"] = step_ms
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
    out["losses"] = [m["loss"] for m in ms]
    out["step_dropped"] = [int(m["num_dropped_pairs"]) for m in ms]
    whole = gather_gaussian_state(local, mesh)
    del local, opt
    if main:
        st = _clone_state(state0)
        o1 = tx.init(st.params)
        step1 = make_train_step(tx, cams, images, cfg)
        for i, c in enumerate(order):
            st, o1, m1 = step1(st, o1, c)
            for k in ("loss", "l1"):
                if _rel(ms[i][k], float(m1[k])) > SHARD_LOSS_RTOL:
                    raise AssertionError(f"step {i} {k}: sharded {ms[i][k]!r}, single "
                                         f"{float(m1[k])!r}")
            if i == 0:
                want = adam_moments(o1)[0]
                out["first_moment_max_norm_err"] = max(
                    compare_grads(f"{spec['case']} first moment {k}", mu_first[k], want[k])
                    for k in want if float(want[k].abs().max()) > 0)
        lrs = {g["name"]: g["lr"] for g in o1.param_groups}
        if world == 1:
            out["params"] = {k: _close(k, whole.params[k], v.detach(), *SHARD_PARAM_TOL)
                             for k, v in st.params.items()}
        else:
            out["params"] = {k: _close_adam(k, whole.params[k], v.detach(), lrs[k])
                             for k, v in st.params.items()}
        out["accum_max_abs_diff"] = _close("xyz_grad_accum", whole.xyz_grad_accum,
                                           st.xyz_grad_accum, *SHARD_ACCUM_TOL)
        if not (torch.equal(whole.denom, st.denom)
                and torch.equal(whole.max_radii2d, st.max_radii2d)):
            raise AssertionError("denom or max_radii2d differ from the single-device steps")
        del st, o1
    del whole

    if spec["case"] == "13a":
        # one step through the a2a exchange: nothing dropped, the same loss
        a2a = TrainConfig(settings=dataclasses.replace(settings, splat_exchange="a2a"),
                          extent=3.0)
        local = shard_gaussian_state(state0, mesh)
        _, _, m = make_sharded_train_step(tx, mesh, cams, images, a2a)(
            local, tx.init(local.params), [order[0]])
        out["a2a_exchange_dropped"] = int(m["num_exchange_dropped"])
        out["a2a_loss_rel"] = _rel(float(m["loss"]), ms[0]["loss"])
        del local
        if out["a2a_exchange_dropped"] or out["a2a_loss_rel"] > SHARD_LOSS_RTOL:
            raise AssertionError(f"a2a step: {out['a2a_exchange_dropped']} splats dropped, "
                                 f"loss {out['a2a_loss_rel']:.3e} relative off all_gather's")
        # data parallel: one camera per rank, the loss the mean of theirs
        dmesh = make_mesh(data=world, gauss=1, device=device)
        pair = [0, len(rcams) - 1]
        local = shard_gaussian_state(state0, dmesh)
        _, _, m = make_sharded_train_step(tx, dmesh, cams, images, cfg)(
            local, tx.init(local.params), pair)
        del local
        if main:
            singles = []
            for c in pair:
                st = _clone_state(state0)
                _, _, m1 = make_train_step(tx, cams, images, cfg)(st, tx.init(st.params), c)
                singles.append(float(m1["loss"]))
            want = sum(singles) / len(singles)
            out["data_parallel_loss_rel"] = _rel(float(m["loss"]), want)
            if out["data_parallel_loss_rel"] > SHARD_LOSS_RTOL:
                raise AssertionError(f"data-parallel loss {float(m['loss'])!r} is not the "
                                     f"mean {want!r} of the cameras' losses {singles}")
    if main:
        with open(spec["out"], "w") as f:
            json.dump(out, f)
    dist.barrier()
    return 0


def phase_sharded_steps(device, case, world, workdir, n=1_000_000, capacity=1 << 20,
                        w=1920, h=1080, max_pairs=BENCH_MAX_PAIRS):
    """Phase 13a (``world`` ranks over gloo on one card) or 13b (one rank
    over NCCL): :func:`sharded_rank` in ``world`` processes through the
    port's launcher. Returns rank 0's numbers."""
    from gsjax_torch.parallel.multihost import spawn_ranks

    out = os.path.join(workdir, f"{case}.json")
    spec = json.dumps({"case": case, "device": device, "n": n, "capacity": capacity,
                       "w": w, "h": h, "max_pairs": max_pairs, "out": out})
    log(f"phase {case}: {world} rank(s), {n} gaussians at {w}x{h}")
    t0 = time.perf_counter()
    res = spawn_ranks([sys.executable, os.path.abspath(__file__), "--sharded-rank", spec],
                      world, SHARD_TIMEOUT_S, cwd=HERE,
                      threads=1 if device == "cpu" else None)
    for rank, r in enumerate(res):
        for line in r.stdout.splitlines():
            log(f"  [{rank}] {line}")
    with open(out) as f:
        report = json.load(f)
    want_backend = "gloo" if world > 1 or device == "cpu" else "nccl"
    if report["backend"] != want_backend:
        raise AssertionError(f"{case}: backend {report['backend']}, want {want_backend}")
    launches_ok = report["step_launches"] == [[0, SHARD_STEPS, SHARD_STEPS]] * world
    if case == "13a":
        launches_ok &= report["render_launches"] == [len(POSES)] * world
    if device == "cuda" and not launches_ok:
        raise AssertionError(f"{case}: launches per rank {report}")
    if device == "cuda" and case == "13a" and len(report.get("strip_kernel_err", [])) != world:
        raise AssertionError(f"{case}: a rank did not check the kernels on its strip {report}")
    if any(report["step_dropped"]):
        raise AssertionError(f"{case}: pairs dropped in the sharded steps {report}")
    log(f"  {case}: {json.dumps(report)}")
    log(f"  {case}: {time.perf_counter() - t0:.1f} s")
    return report


def _rank_summaries(results):
    """The JSON last line of each rank's output."""
    return [json.loads(r.stdout.strip().splitlines()[-1]) for r in results]


def phase_sharded_training(device, run, workdir, iterations=300, ranks=2):
    """Phase 13c: ``python -m gsjax_torch.train --gauss_shards 2`` on phase
    11's scene, two ranks sharing the card, stopped at ``iterations``:
    test PSNR and the counts after each densification against phase 11's
    single-rank run, and each rank's kernel launches."""
    from gsjax_torch.parallel.multihost import spawn_ranks

    model = os.path.join(workdir, "sharded")
    log(f"phase 13c: python -m gsjax_torch.train --gauss_shards {ranks}, {iterations} "
        f"iterations, {ranks} ranks")
    t0 = time.perf_counter()
    res = spawn_ranks([sys.executable, "-m", "gsjax_torch.train", "-s", run["scene"],
                       "-m", model, "--eval", "--device", device, "--disable_viewer",
                       "--iterations", str(iterations), *run["schedule"],
                       "--test_iterations", str(iterations), "--capacity",
                       str(run["capacity"]), "--gauss_shards", str(ranks)],
                      ranks, SUBPROCESS_TIMEOUT_S, cwd=HERE)
    for line in res[0].stdout.splitlines()[-25:]:
        log(f"  [0] {line}")
    done = _rank_summaries(res)
    records = _train_log(model)
    evals = {r["iter"]: r["eval"] for r in records if "eval" in r}
    dens = {r["iter"]: r["num_active"] for r in records if r.get("event") == "densify"}
    grows = [r for r in records if r.get("event") == "capacity_growth"]
    psnr = evals[iterations]["test"]["psnr"]
    gaps = {it: _rel(n, run["densify"][it]) for it, n in dens.items()}
    n_eval = sum(evals[iterations][s]["n_views"] for s in ("test", "train"))
    want = [{"composite_fwd": iterations, "composite_bwd": iterations,
             "composite_infer": n_eval if r == 0 else 0} for r in range(ranks)]
    launches = [d["launches"] for d in done]
    log(f"  test PSNR at {iterations}: {psnr:.4f} (single rank {run['psnr'][iterations]:.4f}); "
        f"after each densification {dens} (single rank "
        f"{ {it: run['densify'][it] for it in dens} }, relative gaps {gaps}); growths "
        f"{[(r['iter'], r['capacity']) for r in grows]}; launches per rank {launches}; wall "
        f"{[d['wall_s'] for d in done]} s; peak memory {[d['peak_memory_gib'] for d in done]} "
        f"GiB; {time.perf_counter() - t0:.1f} s")
    checks = {
        f"test PSNR within {SHARD_PSNR_DB} dB of the single-rank run":
            abs(psnr - run["psnr"][iterations]) <= SHARD_PSNR_DB,
        "the densifications of the single-rank run": set(dens) == {
            it for it in run["densify"] if it <= iterations},
        f"counts after densification within {SHARD_COUNT_REL:.0%}":
            all(g <= SHARD_COUNT_REL for g in gaps.values()),
        "a capacity growth": bool(grows),
        "fwd and bwd once per rank per step, infer once per eval view on rank 0":
            device != "cuda" or launches == want,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"sharded training run: {failed}")
    return {"psnr": psnr, "densify": dens, "gaps": gaps, "launches": launches,
            "wall_s": [d["wall_s"] for d in done]}


def phase_multiscene(device, run, workdir, iterations=100):
    """Phase 13d: ``python -m gsjax_torch.train_multiscene`` with phase
    11's scene under two model paths on two ranks: every rank exits 0 with
    finite losses, and the two scenes' snapshots agree bit for bit (else
    within 1e-6 relative, reported)."""
    from gsjax_torch.data.ply import read_ply
    from gsjax_torch.parallel.multihost import spawn_ranks

    models = [os.path.join(workdir, f"multiscene_{i}") for i in range(2)]
    log(f"phase 13d: python -m gsjax_torch.train_multiscene, 2 scenes on 2 ranks, "
        f"{iterations} iterations")
    t0 = time.perf_counter()
    res = spawn_ranks([sys.executable, "-m", "gsjax_torch.train_multiscene", "-s",
                       run["scene"], run["scene"], "-m", *models, "--eval", "--device", device,
                       "--iterations", str(iterations), "--capacity", str(run["capacity"])],
                      2, SUBPROCESS_TIMEOUT_S, cwd=HERE)
    done = _rank_summaries(res)
    plys = [os.path.join(m, "point_cloud", f"iteration_{iterations}", "point_cloud.ply")
            for m in models]
    with open(plys[0], "rb") as a, open(plys[1], "rb") as b:
        same = a.read() == b.read()
    worst = 0.0
    if not same:
        pa, pb = read_ply(plys[0]), read_ply(plys[1])
        worst = max(float(np.max(np.abs(pa[k] - pb[k]) / np.maximum(np.abs(pb[k]), 1e-30)))
                    for k in pa)
    log(f"  losses {[d['losses'] for d in done]}, launches {[d['launches'] for d in done]}, "
        f"wall {[d['wall_s'] for d in done]} s; snapshots bit for bit equal: {same}"
        + ("" if same else f" (max relative difference {worst:.3e})")
        + f"; {time.perf_counter() - t0:.1f} s")
    if not all(np.isfinite(d["losses"]).all() for d in done):
        raise AssertionError(f"multi-scene: non-finite losses {done}")
    if not same and worst > 1e-6:
        raise AssertionError(f"multi-scene: the two scenes' snapshots differ by {worst:.3e}")
    return {"bit_equal": same, "max_rel": worst}


def phase_scaling_bench():
    """Phase 13e: ``python -m gsjax_torch.scaling_bench`` at gauss 1 (NCCL)
    and 2 (gloo, two ranks on the card): steps/s for each, no pair dropped,
    and the shared-card note."""
    report = json.loads(run_module("13e", ["gsjax_torch.scaling_bench", "--gauss", "1", "2",
                                          "--steps", "5"])[-1])
    checks = {
        "steps/s for gauss 1 and 2": all(report["steps_per_s"].get(k, 0) > 0 for k in "12"),
        "backends nccl, gloo": report["backend"] == {"1": "nccl", "2": "gloo"},
        "no pair dropped": not any(report["num_dropped_pairs"].values()),
        "the shared-card note": "share" in report.get("note", ""),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"scaling_bench: {failed} ({report})")
    return report


def phase_sharded(device, run, workdir):
    """Phase 13, the sharded path (see the module docstring). Returns, per
    compositing kernel, the launches of 13a's counted runs summed over the
    ranks and its largest error against the plain version on a rank's
    strip (the forward's max |diff|, the backward's normalised)."""
    t0 = time.perf_counter()
    a = phase_sharded_steps(device, "13a", 2, workdir)
    phase_sharded_steps(device, "13b", 1, workdir)
    phase_sharded_training(device, run, workdir)
    phase_multiscene(device, run, workdir)
    phase_scaling_bench()
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    err_f, err_b = (max(e[i] for e in a["strip_kernel_err"]) for i in (0, 1))
    return {"composite_infer": (sum(a["render_launches"]), err_f),
            "composite_fwd": (sum(n[1] for n in a["step_launches"]), err_f),
            "composite_bwd": (sum(n[2] for n in a["step_launches"]), err_b)}


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
    from gsjax_torch.utils.profiling import card

    t_start = time.perf_counter()
    smi = card()
    log(f"phase 1: card {smi}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    cuda_composite.load_library(verbose=True)
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    device = "cuda"
    errs512, ts512 = phase_compare(device)
    entries, state, rcams, settings, ts1080 = main_path(device)
    launches = train_path(device, state, rcams, settings)
    for e, err512, n_launch in zip(entries, errs512, (None,) + launches[1:]):
        e["max_abs_err"] = max(e["max_abs_err"], err512)
        if n_launch is not None:
            e["launches"] = n_launch
    del state
    phase_scan_vs_kernel(device)
    phase_cli(device)

    probe_err, probe_times = phase_probe({"entry512": ts512, "bench1080": ts1080})
    probe_launches = phase_probes()
    if probe_launches["sol_probe"] == 0:
        raise AssertionError(f"the probe path launched no sol_probe: {probe_launches}")
    ms, plain, bound, by = probe_times[(40, 0)]  # the slope's heaviest configuration
    entries.append({
        "name": "sol_probe", "route": "cuda", "source": "gsjax_torch/csrc/sol_probe.cu",
        "replaces": "scripts/_r4_session.py:321, scripts/_r5_session.py:327",
        "launches": probe_launches["sol_probe"], "max_abs_err": probe_err,
        "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None,  # no single PyTorch call computes this
        "configs": {f"k_ops={k[0]},k_exp={k[1]}": {"ms": t[0], "plain_ms": t[1],
                                                   "bound_ms": t[2], "bound_by": t[3]}
                    for k, t in probe_times.items()},
    })
    phase_bench()
    with tempfile.TemporaryDirectory() as tmp:
        run = phase_training_run(device, workdir=tmp)
        entries[0]["launches_serving"] = phase_serving(device, run["model"], 600, settings)
        sharded = phase_sharded(device, run, tmp)
    for e in entries[:3]:  # the compositing kernels in 13a: launches, error on a strip
        e["launches_sharded"], e["max_abs_err_sharded"] = sharded[e["name"]]
        e["max_abs_err"] = max(e["max_abs_err"], e["max_abs_err_sharded"])

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--sharded-rank":  # one rank of phase 13
        sys.path.insert(0, HERE)
        sys.exit(sharded_rank(json.loads(sys.argv[2])))
    sys.exit(main())
