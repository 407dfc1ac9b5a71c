#!/usr/bin/env python
"""On-card smoke test of the gsjax_torch port (one NVIDIA GPU).

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``gsjax_torch/csrc`` (one ``nvcc`` per
   source for sm_90a, side by side, into ``build/gsjax_torch/``);
3. each kernel against its plain PyTorch version on the 50,000-gaussian
   512x512 scene and on one frame of the 1M-gaussian 1080p scene, with the
   tolerances stated below (at 1080p also ``preprocess_infer``, the primal
   preprocess, against ``preprocess_plain``: :func:`check_preprocess`; and
   its backward ``preprocess_bwd`` against autograd over
   ``preprocess_plain`` and against ``preprocess_vjp_plain`` at SH degrees
   0-3: :func:`check_preprocess_bwd`);
   ``composite_fwd``'s image against
   ``composite_infer``'s, and both against the forward's check instance,
   its walk without the per-warp cull (``composite_fwd_check``: colors, T
   and ``n_contrib``, bit for bit), with the forward's warp-level work
   (``profiling.fwd_work``); two backward runs bit-identical;
   the backward's check instances (``composite_bwd_counts``): each
   pixel's count of contributing pairs against the plain version's, and
   with the per-warp cull against without it (equal on every pixel, the
   tables bit for bit), and at 1080p the backward's warp-level work
   (``profiling.bwd_work``); then the backward at ``grad_dtype``
   bfloat16 under both roundings (``grad_reduce`` sort: half up, gather:
   to nearest even): the kernel's packed (P, 5) table bit for bit
   ``pack_bf16_pairs`` of its own float32 table, within the gradient tiers
   of the plain version after unpacking (per pair and per gaussian), two
   runs bit-identical, and the check instances' tables the training
   instance's;
4. the render path: the 1M-gaussian 1080p scene rendered through
   ``make_render_fn`` (its captured CUDA graph) for 40 frames from 4
   camera poses, launch counts reset just before and read just after
   (``composite_infer`` and ``preprocess_infer`` once a frame,
   ``preprocess_bwd`` never); then
   per-phase and per-kernel times with CUDA events, the frame's deepest
   tile, and the graphed frame against the eager one (``eager=True``), bit
   for bit at the 4 poses, then 40 frames of each in turns;
5. the training path: 48 steps of ``make_train_step`` (captured graphs)
   on the same scene at full width (targets: the scene with its base color
   shifted, rendered from the 4 poses), in turns at ``grad_dtype`` float32
   and bfloat16 (gsjax's bench and training default), launch counts reset
   just before and read just after; each one's step times and per-phase
   times (its backward kernel and reduction among them) with CUDA events;
   then ``profiling.trace`` (``torch.profiler``) around 4 more float32
   steps: the top kernels by device time and the device's busy share of
   the window; then the graphs against the eager path from one state
   (restored in place), the eager path first twice: 8 steps at each
   ``grad_dtype`` and two chained dispatches of 25 steps, parameters,
   moments, counts, statistics and metrics bit for bit (or as far as the
   eager path agrees with itself); 24 graphed and 24 eager bfloat16 steps
   in turns, the chained dispatches in turns, a trace of 4 steps of each,
   and one replayed dispatch under ``torch.cuda.set_sync_debug_mode
   ("error")``;
6. one train step through the kernel backend against one through the
   differentiable scan backend on a 20,000-gaussian 256x256 scene;
7. the offline-render CLI (``gsjax_torch.render``) on a small synthetic
   scene written to a temporary directory;
8. the speed-of-light probe (``sol_probe``): each instance's registers,
   spills and resident warps (``cuda_probe.sol_probe_info``: its
   occupancy, nothing spilled); against its plain version at the 512x512
   and the 1080p frame's ``tile_start``, for every swept (k_ops, k_exp)
   at 8, 24 and 48 warps per SM, the exp instances also under the check
   coefficients (``cuda_probe.check_exp_coefs``: under the probes' own an
   exp pass forgets its input); its times and bounds (the exps' MUFU term
   included), and at each occupancy the floor, the slopes and the exp
   passes' times linear in their count; then the measurement path as a user
   runs it: ``python -m gsjax_torch.probes --stages
   gather,sort,phases,bwdsplit,bwdcull,fwdcull,vpu,vpux --out`` (the probe path: its
   launch counts come from its last line);
9. ``python -m gsjax_torch.bench --roofline``: a positive frame rate, a
   passed cross-check (its pixels beyond 5e-4 counted and bounded) and no
   dropped pair;
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
    ``composite_bwd`` launched once per step — the backward's bf16
    instance each time, since the trainer's settings ask for
    ``grad_dtype="bfloat16"`` as gsjax's — and ``composite_infer`` once
    per evaluated view (each run's counts are reset at its start and
    printed on its last line), and every step ran through a captured CUDA
    graph (the CLI's ``step_paths``: replays, or a new graph's warm-up; no
    eager step). It prints it/s, the wall time, the growth
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
    gradient, denom and max_radii2d; see the tolerances below), the
    single-device side rendering the frame as the ranks' strips on one
    device (``strip_render``: a strip keys depth with its own tile count,
    as gsjax's; the render's difference to the whole frame is logged), one step
    through the a2a exchange (nothing dropped, the same loss) and a data=2
    step (the loss the mean of the two cameras'), composite_infer once per
    rank per frame and composite_fwd / composite_bwd once per rank per step;
    (13b) the same steps on one rank over NCCL, its first step bit for bit
    the single-device step's at every stage (``grad_chain``); (13c) ``python
    -m gsjax_torch.train --gauss_shards 2`` on two ranks on the scene of
    phase 11, stopped at 300 iterations: test PSNR and the counts after each
    densification against phase 11's run at 300, the kernels once per rank
    per step; (13d) ``python -m gsjax_torch.train_multiscene`` with that
    scene under two model paths on two ranks, 100 iterations: the same
    finite losses on both ranks, finite snapshots (the scenes draw their
    cameras in turn from one generator, as gsjax's); (13e) ``python -m
    gsjax_torch.scaling_bench`` at gauss 1 (NCCL) and 2 (gloo), with its
    shared-card note;
13. the last modules (logged as phase 14): (14a) ``gsjax_torch.native``'s
    kNN on phase 11's sparse cloud and on the 1M bench scene's centres
    against scipy's cKDTree (KNN_RTOL / KNN_ATOL), one and two points, the
    host seconds; (14b) ``python -m gsjax_torch.scale_model`` on phase 11's
    model to SCALE_TARGET gaussians, its first test views at 1080p through
    make_render_fn (no pair dropped, composite_infer once a view, peak
    memory, one frame's phases, composite_infer against its plain version
    at phase 3's tiers), ``render_bench --at_1080p`` and ``viewer_bench``
    on it; (14c) ``python -m gsjax_torch.drop_ab`` from phase 11's
    checkpoint at 300, DROP_ITERS iterations an arm: the baseline arm's
    pair budget overflows (its ``pair_overflow`` records), the big arm's
    does not, both PSNRs finite, the kernels once per step;
    (14d) ``python -m gsjax_torch.densify_grad_ab`` at DENSIFY_AB_ITERS
    iterations an arm: two finite reports; (14e) ``python -m
    gsjax_torch.multichip_split --ranks 2`` at gsjax's operating point:
    every per-rank count within SPLIT_REL of SPLIT_REF; (14f) the port's
    Adam on the card equal to its run on the CPU, bit for bit;
14. gsjax's random keys on the card (logged as phase 15): (15a)
    ``gsjax_torch.utils.prng``'s bits, uniforms and normals for three keys
    at PRNG_SHAPES (a background, an odd length, bench1080's split noise)
    on the card against the same draws on the CPU, bits and uniforms bit
    for bit, normals within NORMAL_ULP (the max printed), then the split
    noise's and a random background's times; (15b) ``python -m
    gsjax_torch.train --random_background`` on phase 11's scene for
    PRNG_RUN_ITERS iterations at the default percent_dense: splits in its
    densifications, a finite test PSNR, the kernels once per step and view;
15. a ``{"kernels": [...]}`` line (``composite_infer``'s
    ``launches_serving``: the bridge's and the viewer's launches, and
    ``launches_scaled`` / ``max_abs_err_scaled``: 14b's; rows 1-3's
    ``launches_sharded``: 13a's counted launches over both ranks, and
    ``max_abs_err_sharded``: their error on a rank's strip; rows 2-3's
    ``launches_drop_ab``: 14c's two arms; row 4, ``preprocess_infer``:
    phase 4's launches, its graphed time and ``ms_eager``, and the byte
    bound over every slot's SH row and over the used slots' only; row 5,
    ``preprocess_bwd``: phase 5's launches, one a step, its graphed time,
    autograd's backward through ``preprocess_plain`` as ``plain_ms``, and
    the byte bound over every slot and over the used slots), the
    card line, and last the
    ``{"ok": true, "device": ...}`` line.

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
# The backward at grad_dtype bfloat16: the kernel and the plain version
# each round their own float32 value, and where the two straddle a bf16
# rounding boundary they come out one unit (2^-8 to 2^-7 of the value)
# apart: measured on an NVIDIA H100 80GB HBM3 (700 W) at the bench frame,
# a pair's r gradient 1.37e-3 of its column's max. So the bf16 tables are
# held to the tiers above on what is left after one rounding unit a pair
# value (compare_bf16_grads), and bit for bit to the kernel's own float32
# table packed.
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
# 4x that. The single-device reference renders the frame as the sharded
# path's strips (strip_render): a strip keys depth with what its own tile
# count leaves of the key, as gsjax's strip does (20 bits at 1080p over two
# strips, the whole frame 19), which orders pairs that tie at 19 bits and
# not at 20 otherwise than the whole frame (measured on an NVIDIA H100 80GB
# HBM3, 700 W: 5.9-6.1% of the bench frame's pixels off by more than
# SHARD_IMG_ATOL, max 0.17, under the grid expansion; logged, as gsjax's
# strips differ from its frame alike).
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

# Phase 14. The port's kNN against scipy's cKDTree at gsjax's own tolerance
# for its tree (tests/test_native.py:17).
KNN_RTOL, KNN_ATOL = 1e-5, 1e-7
SCALE_TARGET = 1_100_000  # gaussians of the scaled trained model (14b)
SCALED_VIEWS = 8
# 14c: the baseline arm's pair-budget multiplier and the big arm's
DROP_MULT_BASELINE = 0.55
DROP_MULT = 2.0
DROP_ITERS = 100  # each arm resumes phase 11's checkpoint at 300 for this many
DENSIFY_AB_ITERS = 600  # 14d, each arm
# 14e: each per-rank count of the sharded path up to binning within this
# share of the committed counts of gsjax's script at the same operating
# point (float32 preprocess on another device can flip a borderline tile)
SPLIT_REL = 1e-4
SPLIT_REF = os.path.join("evidence", "perf", "multichip_split_r5_g2.json")

# Phase 15. gsjax's random keys (gsjax_torch.utils.prng) drawn on the card
# against the same draws on the CPU, where tests/test_torch_prng.py holds
# them to jax.random bit for bit: a background (3,), an odd length and the
# split noise of bench1080's capacity (n_split, 2^20, 3). Every op of a draw
# is IEEE-exact (integer ops, float32 add / multiply / divide, a fused
# multiply-add and a square root rounded once from float64), so the card's
# normals are held bit for bit too: NORMAL_ULP is 0.
PRNG_SHAPES = [(3,), (1001,), (2, 1 << 20, 3)]
NORMAL_ULP = 0
PRNG_RUN_ITERS = 120  # 15b: the random-background training run

# preprocess_infer against preprocess_plain over the used slots (radii >
# 0): the kernel follows the plain version's operation order (it equals it
# bit for bit on the port's K = 16 rows, tests/test_torch_cuda.py), so
# float fields are held to a few ulp and colors and opacities to one f16
# step; integer fields are equal over every slot. The slots whose bits
# differ are logged.
PREP_RTOL = 1e-6
# its bytes a slot: xyz, scale, quaternion, opacity, the active flag (45 B)
# read and the Splats written (64 B), and the SH row (16 x 3 float32, 192 B)
# read only for the used slots; its float32 operations a used slot, an
# estimate from the source (projection, covariance, EWA, conic, radius,
# rectangles, degree-3 SH)
PREP_SLOT_BYTES, PREP_SH_BYTES, PREP_SLOT_OPS = 45 + 64, 192, 300
# preprocess_bwd against autograd over preprocess_plain and against
# preprocess_vjp_plain at every SH degree, on the bench scene with random
# rotations and higher SH coefficients N(0, 0.1), gradients on the used
# slots (tests/test_torch_cuda.py's BWD_TOL, the reasons there): every
# element within PREP_BWD_SLOT of its slot's largest term in its group plus
# PREP_BWD_GROUP of the group's largest, each group's norm of the
# difference within PREP_BWD_NORM of its norm. Its bytes a slot: the 9
# incoming gradients read and the 61 gradient floats written (280 B); where
# a gradient comes in, xyz, scale, quaternion and opacity (32 B) and the SH
# row (192 B at K = 16) read; the bound counts them for every slot (516 B),
# the used bound for the used slots. Its float32 operations a used slot: an
# estimate from the source.
PREP_BWD_SLOT, PREP_BWD_GROUP, PREP_BWD_NORM = 2e-3, 1e-6, 1e-5
PREP_BWD_BYTES, PREP_BWD_USED_BYTES, PREP_BWD_OPS = 36 + 244, 32 + 192, 700
BENCH_MAX_PAIRS = 3_538_944
MAIN_FRAMES = 40  # 10 per pose; the 75th percentile has 10 frames beyond it
TRAIN_STEPS = 48  # in turns at grad_dtype float32 and bfloat16: 6 per pose each
TRACE_STEPS = 4
GRAPH_CHECK_STEPS = 8  # graph against eager, from one state, at each grad_dtype
CHAIN_STEPS = 25  # gsjax's steps_per_dispatch
TURN_ROUNDS, TURN_BLOCK = 4, 6  # graphed and eager steps in turns: 24 each
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


def _grad_diff(name, got, want):
    """(max, p99.9, scale) of |got - want| normalised by max |want|; raises
    past the gradient tiers."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output has non-finite values")
    scale = float(want.abs().max())
    if scale == 0.0:
        raise AssertionError(f"{name}: the plain version's gradients are all zero")
    d = ((got - want).abs() / scale).flatten().sort().values
    mx = float(d[-1])
    p999 = float(d[int(0.999 * (d.numel() - 1))])
    if mx > GRAD_MAX_TOL or p999 > GRAD_P999_TOL:
        raise AssertionError(
            f"{name}: kernel and plain version disagree (max {mx:.3e} > {GRAD_MAX_TOL} "
            f"or p99.9 {p999:.3e} > {GRAD_P999_TOL})")
    return mx, p999, scale


def compare_grads(name, got, want):
    """Normalised by max |want|: p99.9 and max of |got - want|; raises past
    the gradient tiers."""
    mx, p999, scale = _grad_diff(name, got, want)
    log(f"  {name}: normalised max |diff| {mx:.3e}, p99.9 {p999:.3e} (scale {scale:.3e})")
    return mx


def bf16_unit(x):
    """One bf16 rounding unit at each value of ``x``: 2^(e - 8) for |x| in
    [2^(e - 1), 2^e) (8 significant bits), 0 at 0."""
    import torch

    mant, exp = torch.frexp(x.abs().double())
    return torch.where(mant == 0, torch.zeros_like(mant), torch.ldexp(torch.ones_like(mant),
                                                                      exp - 8))


def compare_bf16_grads(name, kb, pb, pair_gauss, tile_start, n_gauss):
    """The kernel's packed bf16 table ``kb`` against the plain version's
    ``pb`` (each its own float32 table rounded), per pair and per gaussian:
    the gradient tiers on what is left of |kernel - plain| after one bf16
    rounding unit per pair value (per gaussian: the sum of its pairs'
    units). Where the two float32 values straddle a rounding boundary
    they round one unit apart; the count of such values is logged. Returns
    the largest normalised max left."""
    import torch

    from gsjax_torch.ops.cuda_composite import reduce_pair_grads, unpack_bf16_pairs

    ku, pu = unpack_bf16_pairs(kb).double(), unpack_bf16_pairs(pb).double()
    unit = bf16_unit(torch.maximum(ku.abs(), pu.abs()))
    kr = reduce_pair_grads(kb, pair_gauss, tile_start, n_gauss).double()
    pr = reduce_pair_grads(pb, pair_gauss, tile_start, n_gauss).double()
    unit_g = reduce_pair_grads(unit.float(), pair_gauss, tile_start, n_gauss).double()
    worst = 0.0
    for level, got, want, units in (("pair", ku, pu, unit), ("per-gaussian", kr, pr, unit_g)):
        apart = int((got != want).sum())
        diffs = []
        for i, nm in enumerate(GRAD_NAMES):
            left = torch.clamp_min((got[:, i] - want[:, i]).abs() - units[:, i], 0.0)
            diffs.append(_grad_diff(f"{name} {level} {nm}", want[:, i] + left, want[:, i]))
        worst = max(worst, max(d[0] for d in diffs))
        log(f"  {name} {level}: {apart} of {got.numel()} values apart; beyond one rounding "
            f"unit a value, normalised max per column {', '.join(f'{d[0]:.2e}' for d in diffs)}"
            f"; p99.9 at most {max(d[1] for d in diffs):.2e}")
    return worst


GRAD_NAMES = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "opacity", "r", "g", "b")
# grad_dtype "bfloat16": each grad_reduce and whether it rounds half up
BF16_MODES = (("sort", True), ("gather", False))


def check_train_kernels(tag, args):
    """composite_fwd and composite_bwd (with the reduction) against their
    plain versions on one frame's inputs ``args``; composite_fwd's image
    against composite_infer's, and both against the forward's walk without
    the cull (colors, T, n_contrib); two backward runs bit-identical; the
    backward's per-pixel contributing counts against the plain version's,
    and with the cull against without it; at ``grad_dtype`` bfloat16, under
    both roundings, the kernel's packed table against its own float32
    table packed (bit for bit) and against the plain version, two runs,
    and the check instances' tables.
    Returns ``(fwd max err, bwd max normalised err, the backward's inputs,
    contributing evaluations, the plain version's backward warp-level
    counts, the forward's warp-level work)``."""
    import torch

    from gsjax_torch.ops.cuda_composite import (
        composite_bwd, composite_bwd_counts, composite_bwd_plain, composite_fwd,
        composite_fwd_check, composite_fwd_plain, composite_grads, composite_infer,
        pack_bf16_pairs, reduce_pair_grads,
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

    for reduce, half_up in BF16_MODES:
        mtag = f"{tag} bf16/{reduce}"
        kb = composite_bwd(*bwd, grad_dtype="bfloat16", grad_reduce=reduce)
        packed = pack_bf16_pairs(kg, half_up=half_up)
        torch.cuda.synchronize()
        if kb.dtype != torch.int32 or not torch.equal(kb, packed):
            raise AssertionError(f"{mtag}: the kernel's packed table differs from its float32 "
                                 f"table packed on {int((kb != packed).any(1).sum())} pairs")
        pb = composite_bwd_plain(*bwd, grad_dtype="bfloat16", grad_reduce=reduce)
        err_b = max(err_b, compare_bf16_grads(mtag, kb, pb, pair_gauss, tile_start, n))
        runs = [composite_grads(*bwd, grad_dtype="bfloat16", grad_reduce=reduce)
                for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"{mtag}: two backward runs differ")
        for cull in (True, False):
            table, c = composite_bwd_counts(*bwd, cull=cull, grad_dtype="bfloat16",
                                            grad_reduce=reduce)
            if not (torch.equal(table, kb) and torch.equal(c, counts)):
                raise AssertionError(f"{mtag}: the check instance (cull {cull}) differs from "
                                     f"the training instance")
        log(f"  {mtag}: the kernel's (P, 5) table == pack_bf16_pairs(its float32 table, "
            f"half_up={half_up}), bit for bit; two runs bit-identical; check instances equal")
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


def time_graph(fn, reps, rounds=5):
    """Median ms of one ``fn()`` call: ``reps`` calls captured in one CUDA
    graph, replayed ``rounds`` times between CUDA events, so the host's
    launch time is not counted (a frame's graph runs its kernels so)."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    del g
    return statistics.median(out)


def _f16_steps(got, want):
    """|got - want| in f16 steps at the larger magnitude (2^-24 below 2^-14)."""
    import torch

    mag = torch.clamp_min(torch.maximum(got.abs(), want.abs()).double(), 2.0 ** -14)
    return ((got.double() - want.double()).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 10))


def check_preprocess(tag, state, rc, settings):
    """``preprocess_infer`` against ``preprocess_plain`` on one frame's
    inputs (``activated(state)``, its SH degree and active mask): integer
    fields equal over every slot; over the used slots (radii > 0) float
    fields within PREP_RTOL, colors and opacities within one f16 step, and
    the slots whose bits differ logged. Then each one's graphed ms a call
    (:func:`time_graph`). Returns (the float fields' largest relative
    error, kernel ms, plain ms, used slots)."""
    import torch

    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.ops.projection import preprocess_infer, preprocess_plain

    ins = activated(state)
    kw = dict(active_mask=state.active, opacity_aware_radius=settings.opacity_aware_radius)

    def kern():
        return preprocess_infer(*ins, rc, state.active_sh_degree, **kw)

    def plain():
        return preprocess_plain(*ins, rc, state.active_sh_degree, **kw)

    k, p = kern(), plain()
    used = p.radii > 0
    n_used = int(used.sum())
    for f in ("radii", "rect_min", "rect_max", "tiles_touched"):
        if not torch.equal(getattr(k, f), getattr(p, f)):
            bad = (getattr(k, f) != getattr(p, f)).reshape(used.shape[0], -1).any(1)
            raise AssertionError(f"{tag} preprocess: {f} differs in {int(bad.sum())} slots")
    err, bits = 0.0, {}
    for f in ("means2d", "depths", "conics", "opacities", "colors"):
        a, b = getattr(k, f)[used], getattr(p, f)[used]
        bits[f] = int((a.view(torch.int32) != b.view(torch.int32)).reshape(n_used, -1)
                      .any(1).sum())
        if f in ("opacities", "colors"):
            steps = float(_f16_steps(a, b).max()) if n_used else 0.0
            if steps > 1.0:
                raise AssertionError(f"{tag} preprocess: {f} {steps} f16 steps off")
            continue
        rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max()) if n_used else 0.0
        if rel > PREP_RTOL:
            raise AssertionError(f"{tag} preprocess: {f} relative error {rel:.3e}")
        err = max(err, rel)
    ms = time_graph(kern, 20)
    plain_ms = time_graph(plain, 5)
    log(f"  {tag} preprocess_infer vs preprocess_plain: {used.numel()} slots, {n_used} used; "
        f"integer fields equal; used slots whose bits differ {json.dumps(bits)}; largest "
        f"relative error {err:.3e}; graphed ms a call: kernel {ms:.4f}, plain {plain_ms:.3f}")
    return err, ms, plain_ms, n_used


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


def frame_phase_ms(state, rc, settings, bg):
    """CUDA-event ms of each phase of one frame, the calls render() makes:
    preprocess, binning, pack, ``composite_infer``, assemble. Returns the
    times and the frame's last outputs (``sp``, ``bins``, ``attrs``,
    ``out``: the kernel's)."""
    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.ops.binning import build_tile_bins
    from gsjax_torch.ops.composite import assemble_image
    from gsjax_torch.ops.cuda_composite import composite_infer, pack_gauss_attrs
    from gsjax_torch.ops.projection import num_tiles, preprocess

    w, h = rc.width, rc.height
    tx, ty = num_tiles(w, h)
    m, s, q, o, sh = activated(state)
    cache = {}

    def f_pre():
        cache["sp"] = preprocess(m, s, q, o, sh, rc, state.active_sh_degree,
                                 active_mask=state.active,
                                 opacity_aware_radius=settings.opacity_aware_radius)

    def f_bin():
        cache["bins"] = build_tile_bins(cache["sp"], tx, ty, settings.max_pairs,
                                        exact_depth_sort=settings.exact_depth_sort,
                                        max_tiles_per_gauss=settings.max_tiles_per_gauss,
                                        tier_frac=settings.tier_frac,
                                        expansion=settings.expansion)

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
    return phases, cache


def _grad_errors(got, want):
    """Per group (the six gradients): the largest element error over its
    slot's largest |want| plus PREP_BWD_GROUP of the group's largest, as a
    share of PREP_BWD_SLOT (<= 1 passes), and the norm of the difference
    over the norm."""
    import torch

    out = []
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        if not bool(torch.isfinite(a).all()):
            return None
        d = (a - b).abs().reshape(a.shape[0], -1)
        row = b.abs().reshape(b.shape[0], -1).amax(1, keepdim=True)
        slot = float(((d - PREP_BWD_GROUP * float(row.max())) / row.clamp_min(1e-300)).max())
        out.append((max(slot, 0.0), float((a - b).norm() / b.norm().clamp_min(1e-300))))
    return out


def check_preprocess_bwd(tag, state, rc):
    """``preprocess_bwd`` against autograd over ``preprocess_plain`` and
    against ``preprocess_vjp_plain`` at SH degrees 0-3, on ``state``'s
    activated inputs with random rotations and higher SH coefficients
    N(0, 0.1) (copies; the state is not touched) and seeded gradients on
    the used slots (radii > 0): PREP_BWD_* tolerances, zero-gradient slots
    exact zeros, the offset's gradient means2d's. Then at degree 3 the
    kernel's graphed ms a call (:func:`time_graph`) and autograd's backward
    through the plain version alone (CUDA events, eager). Returns (the
    largest norm error, kernel ms, autograd ms, used slots)."""
    import torch

    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.ops.projection import (
        preprocess_bwd, preprocess_plain, preprocess_vjp_plain,
    )

    means, scales, _, opac, shs = (x.detach() for x in activated(state))
    g = torch.Generator(device=means.device).manual_seed(22)
    quats = torch.randn((means.shape[0], 4), generator=g, device=means.device)
    quats = quats / quats.norm(dim=1, keepdim=True)
    shs = shs.clone()
    shs[:, 1:] = 0.1 * torch.randn(shs[:, 1:].shape, generator=g, device=means.device)
    ins = [means.contiguous(), scales.contiguous(), quats, opac.contiguous(), shs]
    worst = 0.0
    for deg in range(4):
        with torch.no_grad():
            sp = preprocess_plain(*ins, rc, deg, active_mask=state.active)
        used = (sp.radii > 0).to(torch.float32)
        grads = tuple(scale * torch.randn(x.shape, generator=g, device=x.device)
                      * (used[:, None] if x.dim() == 2 else used)
                      for x, scale in ((sp.means2d, 1e-4), (sp.conics, 1e-3),
                                       (sp.colors, 1e-4), (sp.opacities, 1e-4)))
        kern = preprocess_bwd(*ins, rc, deg, grads)
        leaves = [x.clone().requires_grad_(True) for x in ins]
        off = torch.zeros((means.shape[0], 2), device=means.device, requires_grad=True)
        sp2 = preprocess_plain(*leaves, rc, deg, means2d_offset=off)
        outs = [sp2.means2d, sp2.conics, sp2.colors, sp2.opacities]
        auto = torch.autograd.grad(outs, leaves + [off], grads, retain_graph=deg == 3)
        mirror = preprocess_vjp_plain(*ins, rc, deg, grads)
        for name, want in (("autograd", auto), ("preprocess_vjp_plain", mirror)):
            errs = _grad_errors(kern, want)
            if errs is None:
                raise AssertionError(f"{tag} preprocess_bwd: non-finite gradients")
            bad = [i for i, (slot, norm) in enumerate(errs)
                   if slot > PREP_BWD_SLOT or norm > PREP_BWD_NORM]
            if bad:
                raise AssertionError(f"{tag} preprocess_bwd degree {deg} vs {name}: groups "
                                     f"{bad} off: {errs}")
            worst = max(worst, max(norm for _, norm in errs))
            log(f"  {tag} preprocess_bwd vs {name}, SH degree {deg}: (slot error, norm "
                f"error) per group {json.dumps(errs)}")
        unused = used == 0
        if not all(bool((k[unused] == 0).all()) for k in kern) or not torch.equal(
                kern[5], grads[0]):
            raise AssertionError(f"{tag} preprocess_bwd: zero slots or the offset differ")
    n_used = int(used.sum())
    ms = time_graph(lambda: preprocess_bwd(*ins, rc, 3, grads), 20)
    evs = []
    for _ in range(6):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.autograd.grad(outs, leaves + [off], grads, retain_graph=True)
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    plain_ms = statistics.median(a.elapsed_time(b) for a, b in evs[1:])
    log(f"  {tag} preprocess_bwd: {means.shape[0]} slots, {n_used} used; largest norm error "
        f"{worst:.3e}; kernel {ms:.4f} ms (graphed), autograd through preprocess_plain "
        f"{plain_ms:.3f} ms")
    return worst, ms, plain_ms, n_used


def main_path(device, n=1_000_000, capacity=1 << 20, w=1920, h=1080,
              max_pairs=BENCH_MAX_PAIRS):
    """The 1M-gaussian 1080p scene through make_render_fn, and the three
    compositing kernels and the primal preprocess against their plain
    versions on its first frame. Returns the kernels' entries of the
    ``kernels`` line (the compositing kernels', whose training launches are
    filled in by :func:`train_path`, then ``preprocess_infer``'s), the
    scene, its cameras and settings, and the first frame's ``tile_start``."""
    import torch

    from gsjax_torch.ops.cuda_composite import (
        PACK_W, composite_bwd, composite_bwd_plain, composite_fwd, composite_fwd_plain,
        composite_infer_plain, reduce_pair_grads,
    )
    from gsjax_torch.ops.projection import num_tiles
    from gsjax_torch.train.step import TrainConfig, make_render_fn
    from gsjax_torch.utils.profiling import bound_ms, bwd_work, composite_work
    from gsjax_torch.utils.profiling import launches as launch_counts, launches_since

    log(f"phase 4: main path, {n} gaussians at {w}x{h}")
    state, rcams = bench_scene(device, n, capacity, w, h)
    bg = torch.zeros(3, device=device)
    settings = bench_settings(state, rcams, max_pairs)
    render_fn = make_render_fn(TrainConfig(settings=settings), with_stats=True)
    for rc in rcams:  # warm-up, outside the counted run
        render_fn(state, rc, bg)
    torch.cuda.synchronize()

    launched = launch_counts()
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
    counts = launches_since(launched, ("composite_infer", "preprocess_infer", "preprocess_bwd"))
    launches, prep_launches = counts["composite_infer"], counts["preprocess_infer"]

    frame_ms = [a.elapsed_time(b) for a, b in ev]
    for i, (img, dropped) in enumerate(outs):
        if int(dropped) != 0:
            raise AssertionError(f"frame {i}: {int(dropped)} pairs dropped")
        if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"frame {i}: bad image {tuple(img.shape)} or non-finite")
    if (launches, prep_launches, counts["preprocess_bwd"]) != (MAIN_FRAMES, MAIN_FRAMES, 0):
        raise AssertionError(f"composite_infer launched {launches} times, preprocess_infer "
                             f"{prep_launches} and preprocess_bwd "
                             f"{counts['preprocess_bwd']} for {MAIN_FRAMES} frames")
    med = statistics.median(frame_ms)
    p75 = statistics.quantiles(frame_ms, n=4)[2]
    log(f"  {MAIN_FRAMES} frames from {len(rcams)} poses, num_dropped 0, finite")
    log(f"  frame ms (CUDA events, n={MAIN_FRAMES}): median {med:.3f}, p75 {p75:.3f}, "
        f"min {min(frame_ms):.3f}, max {max(frame_ms):.3f}; fps {1000.0 / med:.2f}; "
        f"host wall {1000.0 * wall_s / MAIN_FRAMES:.3f} ms/frame")

    # per-phase times of one frame, the same calls as render() makes
    tx, ty = num_tiles(w, h)
    with torch.no_grad():
        phases, cache = frame_phase_ms(state, rcams[0], settings, bg)
        log("  phase ms: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
        prep_err, prep_ms, prep_plain_ms, n_used = check_preprocess(
            "1080p", state, rcams[0], settings)
    bwd_err, bwd_prep_ms, bwd_prep_plain_ms, bwd_used = check_preprocess_bwd(
        "1080p", state, rcams[0])
    with torch.no_grad():
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
        n_gauss = cache["attrs"].shape[0]
        pair_grads = composite_bwd(*bwd)
        reduce_ms = time_cuda(lambda: reduce_pair_grads(
            pair_grads, b.pair_gauss, b.tile_start, n_gauss), 10)
        # gsjax's bench and training default: bf16 pairs, rounded half up
        # (grad_reduce "sort"); the two dtypes' kernels and reductions in turns
        bf16 = dict(grad_dtype="bfloat16", grad_reduce="sort")
        packed = composite_bwd(*bwd, **bf16)
        bwd_t = {"float32": [], "bfloat16": []}
        red_t = {"float32": [], "bfloat16": []}
        for _ in range(4):
            for dt, kw, table in (("float32", {}, pair_grads), ("bfloat16", bf16, packed)):
                bwd_t[dt].append(time_cuda(lambda: composite_bwd(*bwd, **kw), 5))
                red_t[dt].append(time_cuda(lambda: reduce_pair_grads(
                    table, b.pair_gauss, b.tile_start, n_gauss), 5))
        bwd_bf16_ms = statistics.median(bwd_t["bfloat16"])
        reduce_bf16_ms = statistics.median(red_t["bfloat16"])
    log(f"  composite_fwd {fwd_ms:.3f} ms (plain {fwd_plain_ms:.1f}); composite_bwd "
        f"{bwd_ms:.3f} ms (plain {bwd_plain_ms:.1f}); reduction to gaussians "
        f"{reduce_ms:.3f} ms")
    log(f"  in turns, 4 rounds of 5 calls, median: composite_bwd float32 "
        f"{statistics.median(bwd_t['float32']):.4f} ms, bfloat16 {bwd_bf16_ms:.4f} ms; "
        f"reduction float32 {statistics.median(red_t['float32']):.4f} ms, bfloat16 "
        f"{reduce_bf16_ms:.4f} ms (rounds {json.dumps(bwd_t)}, {json.dumps(red_t)})")

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
    work_bf16 = composite_work(b.pair_gauss, cache["attrs"], tx, ty, fwd_walk, fw["blends"],
                               walk, n_live, bwd_row_words=PACK_W)["composite_bwd"]
    # exps: the forward's per tested pixel, the backward's per contribution
    entries = [
        entry(name, f"gsjax/ops/pallas_composite.py:{line}", launches_, err_, ms, plain,
              *work[name], exps=exps)
        for name, line, launches_, err_, ms, plain, exps in (
            ("composite_infer", 561, launches, err, phases["kernel"], plain_ms, fw["exps"]),
            ("composite_fwd", 396, 0, err_f, fwd_ms, fwd_plain_ms, fw["exps"]),
            ("composite_bwd", 754, 0, err_b, bwd_ms, bwd_plain_ms, n_live),
        )
    ]
    # the primal preprocess: every slot's inputs and outputs, and the SH rows
    # of every slot (the bound) or of the used ones (what the kernel reads)
    n_slots = state.capacity
    prep = entry("preprocess_infer", "gsjax/ops/projection.py:preprocess (jnp, XLA-fused)",
                 prep_launches, prep_err, prep_ms, prep_plain_ms,
                 n_slots * (PREP_SLOT_BYTES + PREP_SH_BYTES), n_used * PREP_SLOT_OPS)
    prep.update(ms_eager=phases["preprocess"], bound_ms_used=bound_ms(
        n_slots * PREP_SLOT_BYTES + n_used * PREP_SH_BYTES, n_used * PREP_SLOT_OPS)[0],
        slots=n_slots, used_slots=n_used)
    # its backward: launches filled in by train_path; plain ms is autograd's
    # backward through preprocess_plain at the same state
    prep_bwd = entry("preprocess_bwd", "gsjax/ops/projection.py:preprocess's VJP (jnp, "
                     "differentiated by XLA)", 0, bwd_err, bwd_prep_ms, bwd_prep_plain_ms,
                     n_slots * (PREP_BWD_BYTES + PREP_BWD_USED_BYTES),
                     bwd_used * PREP_BWD_OPS)
    prep_bwd.update(bound_ms_used=bound_ms(
        n_slots * PREP_BWD_BYTES + bwd_used * PREP_BWD_USED_BYTES, bwd_used * PREP_BWD_OPS)[0],
        slots=n_slots, used_slots=bwd_used)
    # the bf16 instance (grad_dtype "bfloat16", grad_reduce "sort"): 20
    # bytes a pair written instead of 36
    bound, by = bound_ms(*work_bf16, n_live)
    log(f"  composite_bwd bf16 bound: {work_bf16[0]} bytes, {work_bf16[1]} float32 ops, "
        f"{n_live} exps -> {bound:.4f} ms ({by})")
    entries[2].update(ms_bf16=bwd_bf16_ms, bound_ms_bf16=bound, bound_by_bf16=by,
                      reduce_ms=reduce_ms, reduce_ms_bf16=reduce_bf16_ms)
    # gsjax's n_contrib is exact below ~2^16 pairs a tile: this frame's deepest
    deepest = deepest_tile(b.tile_start)
    log(f"  deepest tile: {deepest} pairs")
    for e in entries:
        e["deepest_tile_pairs_bench1080"] = deepest
    graph_frames(state, rcams, render_fn, TrainConfig(settings=settings), bg)
    return entries + [prep, prep_bwd], state, rcams, settings, b.tile_start


def deepest_tile(tile_start):
    """The longest range of ``tile_start``: the most pairs a tile holds."""
    return int((tile_start[1:] - tile_start[:-1]).max())


def graph_frames(state, rcams, render_fn, cfg, bg):
    """Phase 4's graph part: the captured frame of ``render_fn`` against
    the eager frame, bit for bit at each pose, then MAIN_FRAMES frames of
    each in turns (CUDA events; the host's time to enqueue a frame)."""
    import torch

    from gsjax_torch.train.step import make_render_fn

    eager_fn = make_render_fn(cfg, with_stats=True, eager=True)
    for i, rc in enumerate(rcams):
        (gi, gd), (ei, ed) = render_fn(state, rc, bg), eager_fn(state, rc, bg)
        if not (torch.equal(gi, ei) and torch.equal(gd, ed)):
            raise AssertionError(f"pose {i}: the graphed frame differs from the eager one "
                                 f"(max |diff| {float((gi - ei).abs().max()):.3e})")
    torch.cuda.synchronize()
    times = {"graph": ([], []), "eager": ([], [])}
    for i in range(2 * MAIN_FRAMES):
        name, fn = (("graph", render_fn), ("eager", eager_fn))[i % 2]
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn(state, rcams[(i // 2) % len(rcams)], bg)
        z.record()
        times[name][1].append(1e3 * (time.perf_counter() - t0))
        times[name][0].append((a, z))
    torch.cuda.synchronize()
    parts = []
    for name, (evs, host) in times.items():
        ms = [a.elapsed_time(z) for a, z in evs]
        parts.append(f"{name} median {statistics.median(ms):.3f}, p75 "
                     f"{statistics.quantiles(ms, n=4)[2]:.3f}, host enqueue "
                     f"{statistics.median(host):.3f}")
    log(f"  graphed frame = eager frame bit for bit at {len(rcams)} poses; in turns, "
        f"{MAIN_FRAMES} frames each, ms (CUDA events): " + "; ".join(parts)
        + f"; captures {render_fn.graphs.captures}")


def entry(name, replaces, launches, err, ms, plain_ms, bytes_moved, ops, library_ms=None,
          exps=0):
    """One kernel's entry of the ``kernels`` line; its bound from the bytes,
    operations and exps of this run's inputs (``profiling.bound_ms``)."""
    from gsjax_torch.utils.profiling import bound_ms

    bound, by = bound_ms(bytes_moved, ops, exps)
    log(f"  {name} bound: {bytes_moved} bytes, {ops} float32 ops, {exps} exps -> "
        f"{bound:.4f} ms ({by}; without the exps' term "
        f"{bound_ms(bytes_moved, ops)[0]:.4f} ms)")
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
                               ncon, tx, ty, grad_dtype=s.grad_dtype, grad_reduce=s.grad_reduce)
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
    """The training path at full width: 48 steps of make_train_step on the
    bench scene, in turns at ``grad_dtype`` float32 (``settings``) and
    bfloat16 (gsjax's default, rounded half up under ``grad_reduce``
    "sort"), each one's steps split in phases, and a trace of 4 more
    float32 steps. Returns the launch counts of (composite_infer,
    composite_fwd, composite_bwd, composite_bwd's bf16 instances,
    preprocess_bwd) in the counted run."""
    import dataclasses

    import torch

    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.data.cameras import stack_render_cameras
    from gsjax_torch.train.optim import make_optimizer
    from gsjax_torch.train.step import TrainConfig, make_train_step
    from gsjax_torch.utils.profiling import device_summary, trace
    from gsjax_torch.utils.profiling import launches as launch_counts, launches_since

    w, h = rcams[0].width, rcams[0].height
    log(f"phase 5: training path, {TRAIN_STEPS} steps of make_train_step, "
        f"{int(state.num_active)} gaussians at {w}x{h}, in turns at grad_dtype float32 and "
        f"bfloat16")
    cfgs = {dt: TrainConfig(settings=dataclasses.replace(settings, grad_dtype=dt,
                                                         grad_reduce="sort"), extent=3.0)
            for dt in ("float32", "bfloat16")}
    cfg = cfgs["float32"]
    images = shifted_targets(state, rcams, cfg, device)
    tx = make_optimizer(OptimizationParams(), 3.0)
    opt = tx.init(state.params)
    cams = stack_render_cameras(rcams, device)
    steps = {dt: make_train_step(tx, cams, images, c) for dt, c in cfgs.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    launched = launch_counts()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(TRAIN_STEPS)]
    metrics = []
    order = [("float32", "bfloat16")[i % 2] for i in range(TRAIN_STEPS)]
    t0 = time.perf_counter()
    for i, dt in enumerate(order):  # each pose twice in a row, once at each dtype
        ev[i][0].record()
        state, opt, m = steps[dt](state, opt, (i // 2) % len(rcams))
        ev[i][1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = tuple(launches_since(launched, ("composite_infer", "composite_fwd", "composite_bwd",
                                               "composite_bwd_bf16", "preprocess_bwd")).values())

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
    want = (0, TRAIN_STEPS, TRAIN_STEPS, TRAIN_STEPS // 2, TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"launches (infer, fwd, bwd, bwd bf16, preprocess_bwd) "
                             f"{launches}, want {want}")
    log(f"  {TRAIN_STEPS} steps from {len(rcams)} poses: num_dropped 0, finite params; "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f} (mean of first 4 {first:.6f}, last 4 "
        f"{last:.6f}); launches infer/fwd/bwd/bwd bf16/preprocess_bwd {launches}")
    by_dt = {dt: [t for t, d in zip(step_ms, order) if d == dt] for dt in steps}
    f32 = by_dt["float32"]
    log(f"  step ms (CUDA events, n={len(f32)}): median {statistics.median(f32):.3f}, "
        f"p75 {statistics.quantiles(f32, n=4)[2]:.3f}, min {min(f32):.3f}, "
        f"max {max(f32):.3f}; grad_dtype float32; host wall (both) "
        f"{1000.0 * wall_s / TRAIN_STEPS:.3f} ms/step; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    bf = by_dt["bfloat16"]
    log(f"  grad_dtype bfloat16 steps, ms over n={len(bf)} (CUDA events): median "
        f"{statistics.median(bf):.3f}, p75 {statistics.quantiles(bf, n=4)[2]:.3f}, "
        f"min {min(bf):.3f}, max {max(bf):.3f}")

    gt = images[0].to(torch.float32) / 255.0
    rounds = {dt: [] for dt in steps}
    for _ in range(4):  # in turns; the first round is a warm-up
        for dt, c in cfgs.items():
            rounds[dt].append(step_phases(state, opt, rcams[0], gt, c))
    for dt, label in (("float32", "one step's phases"),
                      ("bfloat16", "one grad_dtype bfloat16 step's phases")):
        ph = {k: statistics.median(r[k] for r in rounds[dt][1:]) for k in rounds[dt][0]}
        log(f"  {label}, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ph.items())
            + f"; sum {sum(ph.values()):.3f}")

    # torch.profiler over a few more steps: kernels by device time, and the
    # share of the window in which the device was busy
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            for i in range(TRACE_STEPS):
                state, opt, _ = steps["float32"](state, opt, i % len(rcams))
            torch.cuda.synchronize()
        summary = device_summary(prof)
    if summary is None:
        log("  device time: not measured (torch.profiler recorded none)")
    else:
        log(f"  trace of {TRACE_STEPS} steps: device busy {summary['busy_ms']:.3f} ms of a "
            f"{summary['window_ms']:.3f} ms window, busy share {summary['busy_share']:.4f}")
        for name, ms, calls in summary["top"]:
            log(f"    {ms:9.3f} ms  {calls:6d} calls  {name[:100]}")
    graph_steps(state, opt, tx, cams, images, cfgs, steps)
    return launches


def graph_steps(state, opt, tx, cams, images, cfgs, steps):
    """Phase 5's graph part: the captured step and chained dispatch against
    the eager path from one state (restored in place between runs), the
    eager path first against itself; then graphed and eager bf16 steps in
    turns, their chained dispatches in turns, a trace of 4 steps of each,
    and one replayed dispatch under ``torch.cuda.set_sync_debug_mode
    ("error")``."""
    import torch

    from gsjax_torch.train.step import (
        make_train_step, make_train_step_chained, restore, snapshot,
        snapshot_differences as differing,
    )
    from gsjax_torch.utils.profiling import device_summary, trace

    eager = {dt: make_train_step(tx, cams, images, c, eager=True) for dt, c in cfgs.items()}
    start = snapshot(state, opt)
    n_cam = len(cams)

    def run(fn, calls):
        restore(state, opt, start)
        ms = [fn(state, opt, *a)[2] for a in calls]
        torch.cuda.synchronize()
        return ms, snapshot(state, opt)

    def agree(name, got, want, unstable):
        (gm, g), (em, e) = got, want
        diff = [k for k in differing(g, e) if k not in unstable]
        mdiff = [k for k in gm[-1] if not torch.equal(gm[-1][k], em[-1][k])]
        if diff or (mdiff and not unstable):
            raise AssertionError(f"{name}: the graph differs from the eager path in {diff}, "
                                 f"metrics {mdiff}")
        how = "bit for bit" if not unstable else f"except {unstable}, where eager differs too"
        log(f"  {name}: graph = eager {how} (parameters, Adam's moments and counts, the "
            f"statistics, the metrics)")

    t0 = time.perf_counter()
    calls = [(i % n_cam,) for i in range(GRAPH_CHECK_STEPS)]
    unstable = differing(run(eager["bfloat16"], calls)[1], run(eager["bfloat16"], calls)[1])
    log(f"  eager twice from one state, {GRAPH_CHECK_STEPS} bfloat16 steps: "
        + ("bit for bit (deterministic)" if not unstable else f"differ in {unstable}"))
    for dt in cfgs:
        agree(f"{GRAPH_CHECK_STEPS} {dt} steps", run(steps[dt], calls), run(eager[dt], calls),
              unstable)
    chained = {e: make_train_step_chained(tx, cams, images, cfgs["bfloat16"], CHAIN_STEPS,
                                          eager=e) for e in (False, True)}
    ccalls = [([(i + j) % n_cam for i in range(CHAIN_STEPS)],) for j in range(2)]
    agree(f"two chained dispatches of {CHAIN_STEPS} bfloat16 steps (the graph's first its "
          f"warm-up, the second a replay)", run(chained[False], ccalls),
          run(chained[True], ccalls), unstable)
    g_step = next(iter(steps["bfloat16"].graphs.entries.values()))[1][3]
    g_chain = next(iter(chained[False].graphs.entries.values()))[1][3]
    log(f"  graph checks: {time.perf_counter() - t0:.1f} s; capture of a step "
        f"{g_step.capture_s:.3f} s, of a {CHAIN_STEPS}-step dispatch {g_chain.capture_s:.3f} s "
        f"(host, with the instantiation)")

    # in turns: blocks of TURN_BLOCK graphed and eager bfloat16 steps
    restore(state, opt, start)
    fns = {"graph": steps["bfloat16"], "eager": eager["bfloat16"]}
    ms = {k: [] for k in fns}
    wall = {k: [] for k in fns}
    for r in range(TURN_ROUNDS):
        for name, fn in fns.items():
            ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(TURN_BLOCK)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i, (a, z) in enumerate(ev):
                a.record()
                fn(state, opt, (r + i) % n_cam)
                z.record()
            torch.cuda.synchronize()
            wall[name].append(1e3 * (time.perf_counter() - t) / TURN_BLOCK)
            ms[name] += [a.elapsed_time(z) for a, z in ev]
    for name in fns:
        log(f"  {name} bfloat16 step, in turns ({TURN_ROUNDS} rounds of {TURN_BLOCK}), ms "
            f"(CUDA events, n={len(ms[name])}): median {statistics.median(ms[name]):.3f}, p75 "
            f"{statistics.quantiles(ms[name], n=4)[2]:.3f}, min {min(ms[name]):.3f}; host wall "
            f"per step {statistics.median(wall[name]):.3f}")
    per_step = {k: [] for k in chained}
    for r in range(2):
        for e, fn in chained.items():
            torch.cuda.synchronize()
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(state, opt, [(r + i) % n_cam for i in range(CHAIN_STEPS)])
            z.record()
            torch.cuda.synchronize()
            per_step[e].append(a.elapsed_time(z) / CHAIN_STEPS)
    log(f"  chained dispatch of {CHAIN_STEPS} bfloat16 steps, in turns, ms a step: graph "
        f"{per_step[False]}, eager {per_step[True]}")

    for name, fn in fns.items():
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp) as prof:
                for i in range(TRACE_STEPS):
                    fn(state, opt, i % n_cam)
                torch.cuda.synchronize()
            summary = device_summary(prof)
        if summary is None:
            log(f"  {name} trace: device time not measured (torch.profiler recorded none)")
        else:
            log(f"  {name} bfloat16 trace of {TRACE_STEPS} steps: device busy "
                f"{summary['busy_ms']:.3f} ms of a {summary['window_ms']:.3f} ms window, "
                f"share {summary['busy_share']:.4f}")

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chained[False](state, opt, [i % n_cam for i in range(CHAIN_STEPS)])
        steps["bfloat16"](state, opt, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("  a replayed chained dispatch and step under set_sync_debug_mode('error'): no host "
        f"sync; captures: step {steps['bfloat16'].graphs.captures}, chained "
        f"{chained[False].graphs.captures}")


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
    ``tile_start`` for every swept (k_ops, k_exp) at every occupancy, the
    exp instances under both coefficient sets; each instance's registers,
    spills and resident warps, which must be its occupancy with nothing
    spilled; then the times at the last frame's (the 1080p one), whose exp
    passes must cost alike at each occupancy. Returns ``(max |kernel -
    plain|, {((k_ops, k_exp), warps per SM): (ms, plain ms, bound ms,
    bound by)})``."""
    import torch

    from gsjax_torch.ops.cuda_probe import (
        OCCUPANCIES, PROBE_EXP, SWEPT, check_exp_coefs, sol_probe, sol_probe_info,
        sol_probe_inputs, sol_probe_plain,
    )
    from gsjax_torch.utils.profiling import bound_ms, sol_probe_work

    log("phase 8: sol_probe against its plain version")
    for k in SWEPT:
        for w in OCCUPANCIES:
            for check in (False, True) if k[1] else (False,):
                info = sol_probe_info(*k, w, check)
                log(f"  instance {k} at {w} warps per SM{' (check)' if check else ''}: "
                    f"{info['registers']} registers, {info['local_bytes']} local bytes a "
                    f"thread, {info['blocks_per_sm']} blocks of {info['threads']} threads per "
                    f"SM = {info['resident_warps']} warps, {info['smem_bytes']} B shared a "
                    f"block")
                if info["resident_warps"] != w or info["local_bytes"] != 0:
                    raise AssertionError(f"sol_probe {k} at {w} warps per SM: {info}")
    worst = 0.0
    for tag, ts in tile_starts.items():
        ts = ts.contiguous()
        table = sol_probe_inputs(ts, seed=0)
        for k in SWEPT:
            coef_sets = [("probe", PROBE_EXP)]
            if k[1]:
                coef_sets.append(("check", check_exp_coefs(k[0])))
            for cname, coefs in coef_sets:
                want = sol_probe_plain(ts, table, *k, coefs)
                for w in OCCUPANCIES:
                    got = sol_probe(ts, table, *k, coefs, warps_per_sm=w)
                    torch.cuda.synchronize()
                    name = f"sol_probe {tag} {k} at {w} warps, {cname} coefficients"
                    if not bool(torch.isfinite(got).all()):
                        raise AssertionError(f"{name}: non-finite output")
                    diff = (got - want).abs()
                    rel = float((diff / want.abs().clamp_min(1e-30)).max())
                    worst = max(worst, float(diff.max()))
                    log(f"  {name}: max |diff| {float(diff.max()):.3e}, max relative "
                        f"{rel:.3e} (out max {float(want.abs().max()):.1f})")
                    if rel > PROBE_RTOL:
                        raise AssertionError(f"{name}: relative error {rel:.3e} > {PROBE_RTOL}")
    times = {}
    for k in SWEPT:
        plain = time_cuda(lambda: sol_probe_plain(ts, table, *k), 2)
        bytes_, ops, elements, exps = sol_probe_work(ts, *k)
        bound, by = bound_ms(bytes_, ops, exps)
        log(f"  {tag} {k}: plain {plain:.3f} ms; {elements} elements, {ops} float32 ops, "
            f"{exps} exps, {bytes_} bytes -> bound {bound:.4f} ms ({by}; without the exps' "
            f"term {bound_ms(bytes_, ops)[0]:.4f} ms)")
        for w in OCCUPANCIES:
            ms = time_cuda(lambda: sol_probe(ts, table, *k, warps_per_sm=w), 10)
            times[(k, w)] = (ms, plain, bound, by)
            log(f"  {tag} {k} at {w} warps per SM: kernel {ms:.4f} ms, {bound / ms:.3f} of "
                f"the bound")
    for w in OCCUPANCIES:
        t = {k: times[(k, w)][0] for k in SWEPT}
        slope = (t[(40, 0)] - t[(4, 0)]) / 36
        e5, e10 = (t[(20, e)] - t[(20, 0)] for e in (5, 10))
        ratio = e10 / (2 * e5)
        log(f"  {w} warps per SM: floor {t[(4, 0)] - 4 * slope:.4f} ms, {slope:.5f} ms per "
            f"multiply-add pass, {e10 / 10:.5f} ms per exp pass; 5 exp passes take "
            f"{e5:.4f} ms, 10 take {e10:.4f} ms; linearity {ratio:.4f}")
        if abs(ratio - 1) > EXP_LINEAR_TOL:
            raise AssertionError(f"sol_probe at {w} warps per SM: 10 exp passes take "
                                 f"{ratio:.4f} x twice 5's")
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
    rate, a passed cross-check (its pixels beyond 5e-4 counted and
    bounded), no dropped pair, a roofline fraction that a card can reach
    and the probes' ceilings."""
    from gsjax_torch.bench import XCHECK_BEYOND_MAX

    result = json.loads(run_module(10, ["gsjax_torch.bench", "--roofline"])[-1])
    ex = result["extra"]
    checks = {
        "value > 0": (result["value"] or 0) > 0,
        "cross-check passed": isinstance(ex["backend_xcheck_max_diff"], float)
        and ex["backend_xcheck_max_diff"] <= MAX_TOL
        and max(ex["backend_xcheck_beyond_5e-4"].values()) <= XCHECK_BEYOND_MAX,
        "num_dropped == 0": ex["num_dropped"] == 0,
        "0 < roofline_frac <= 1": 0 < ex["roofline_frac"] <= 1,
        "roofline_ref from the probes": isinstance(ex["roofline_ref"], dict),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bench: {failed}")
    log(f"  bench: {result['value']} frames/s, fwd+bwd {ex['fwd_bwd_frames_per_s']}, train "
        f"{ex['train_iters_per_s']} it/s, cross-check {ex['backend_xcheck_max_diff']}, pixels "
        f"beyond 5e-4 {ex['backend_xcheck_beyond_5e-4']} (at most {XCHECK_BEYOND_MAX})")


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
            f"{done['launches']} (want {want}), of composite_bwd's the bf16 instance's "
            f"{done['bwd_launches_bf16']} (grad_dtype bfloat16, gsjax's training default); "
            f"max opacity after the reset {opac.max():.5f}")
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
            "the backward's bf16 instance every step (grad_dtype bfloat16)":
                device != "cuda" or done["bwd_launches_bf16"] == iterations,
            "every step through a captured graph (replays, or a new graph's warm-up)":
                device != "cuda" or (done["step_paths"]["eager"] == 0
                                     and done["step_paths"]["graph"] > 0
                                     and sum(done["step_paths"].values()) == iterations),
        }
        log(f"  steps by path: {done['step_paths']} (graph: replays; capture: a new graph's "
            f"warm-up, run eagerly on the capture stream); graphs captured "
            f"{done['graph_captures']}")

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
        checks["resumed launches"] = device != "cuda" or (
            done2["launches"] == want2 and done2["bwd_launches_bf16"] == resume
            and done2["step_paths"]["eager"] == 0)

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
            "checkpoint_iter": half,
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
    from gsjax_torch.train.step import TrainConfig, make_render_fn
    from gsjax_torch.utils.profiling import launches as launch_counts, launches_since
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
    launched = launch_counts()
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
    launches = launches_since(launched, ("composite_infer",))["composite_infer"]
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
    from gsjax_torch.train.step import TrainConfig, make_render_fn, quantize
    from gsjax_torch.utils.profiling import launches as launch_counts, launches_since
    from gsjax_torch.viewer.local_viewer import LocalViewer

    log(f"phase 12c: the local viewer, {frames} frames of the bench scene at {w}x{h}")
    viewer = LocalViewer(state, np.zeros(3, np.float32), port=0, device=device)
    torch.cuda.synchronize()
    launched = launch_counts()
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
    launches = launches_since(launched, ("composite_infer",))["composite_infer"]
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


def _frame_diff(img, ref):
    """max |diff| and the pixels beyond SHARD_IMG_ATOL of two renders."""
    d = (img - ref).abs().amax(-1)
    return {"max_abs_diff": float(d.max()), "pixels_beyond": int((d > SHARD_IMG_ATOL).sum()),
            "pixels": d.numel()}


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


def strip_render(gauss):
    """``rasterize.render`` with the frame cut into ``gauss`` strips of tile
    rows, each binned as a rank of the sharded path bins its strip
    (``shard.bin_strip``: its own key width, as gsjax's strip) and blended
    as the rank blends it (``shard.blend_strip``), on one device with no
    exchange: the single-device reference of the sharded path."""
    import torch

    from gsjax_torch.ops.projection import num_tiles, preprocess
    from gsjax_torch.parallel.shard import _cdiv, bin_strip, blend_strip

    def render(camera, means3d, scales, quats, opacities, shs, sh_degree, bg, settings, *,
               scale_modifier=1.0, colors_precomp=None, cov3d_precomp=None,
               active_mask=None, means2d_offset=None):
        tiles_x, tiles_y = num_tiles(camera.width, camera.height)
        strips_y = _cdiv(tiles_y, gauss)
        splats = preprocess(means3d, scales, quats, opacities, shs, camera, sh_degree,
                            scale_modifier=scale_modifier, cov3d_precomp=cov3d_precomp,
                            colors_precomp=colors_precomp, active_mask=active_mask,
                            means2d_offset=means2d_offset,
                            opacity_aware_radius=settings.opacity_aware_radius)
        bg = torch.as_tensor(bg, dtype=torch.float32, device=means3d.device)
        imgs, ts, counts = [], [], []
        for g in range(gauss):
            bins = bin_strip(splats, g * strips_y, strips_y, tiles_x, settings, gauss)
            img, t_img, capped = blend_strip(splats, bins, g * strips_y, strips_y, tiles_x,
                                             camera.width, bg, settings)
            imgs.append(img)
            ts.append(t_img)
            counts.append(torch.stack([bins.num_dropped, bins.num_mt_capped,
                                       bins.num_tier_capped, capped.to(bins.num_dropped.dtype)]))
        counts = torch.stack(counts).sum(0).to(torch.int32)
        return {"render": torch.cat(imgs)[:camera.height], "radii": splats.radii,
                "visibility_filter": splats.radii > 0,
                "final_T": torch.cat(ts)[:camera.height], "num_dropped": counts[0],
                "num_mt_capped": counts[1], "num_tier_capped": counts[2],
                "num_tile_capped": counts[3]}

    return render


@contextlib.contextmanager
def strips_on_one_device(gauss):
    """``make_render_fn`` and ``make_train_step`` render through
    :func:`strip_render` inside the block (one strip: unchanged)."""
    from gsjax_torch.train import step

    if gauss == 1:
        yield
        return
    render = step.render
    step.render = strip_render(gauss)
    try:
        yield
    finally:
        step.render = render


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
        adam_update = opt.update

        def update_keeping_grads(*a, **k):
            got["grads"] = {n: v.grad.detach().clone() for n, v in state.params.items()}
            return adam_update(*a, **k)

        opt.update = update_keeping_grads
        module.composite = wrapped
        try:
            step(state, opt, cam_arg)
        finally:
            module.composite = orig
        return got

    sharded = run(shard, make_sharded_train_step(tx, mesh, cams, images, cfg),
                  shard_gaussian_state(state0, mesh), [cam])
    # eager: the hooks above record tensors as the step runs
    single = run(rasterize, make_train_step(tx, cams, images, cfg, eager=True),
                 _clone_state(state0), cam)
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
    from gsjax_torch.utils.profiling import launches as launch_counts, launches_since

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
    cams = stack_render_cameras(rcams, dev)
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
        launched = launch_counts()
        frames = [timed(lambda rc=rc: render(local, rc, bg)) for rc in rcams]
        out["render_launches"] = global_to_host_local(torch.tensor(
            launches_since(launched, ("composite_infer",))["composite_infer"])).tolist()
        out["frame_ms"] = [ms for _, ms in frames]
        out["render_dropped"] = [int(f[2]) for f, _ in frames]
        del local
        if main:
            # the single-device reference runs eager: strips_on_one_device
            # rebinds train.step.render, which a captured graph would not see
            single = make_render_fn(cfg, with_stats=True, eager=True)
            errs, out["grid_whole_frame"] = [], []
            for (img, _, _), rc in zip((f for f, _ in frames), rcams):
                whole_frame = single(state0, rc, bg)[0]
                with strips_on_one_device(world):
                    ref, dropped = single(state0, rc, bg)
                if int(dropped):
                    raise AssertionError(f"single-device render dropped {int(dropped)} pairs")
                errs.append(float((img - ref).abs().max()))
                out["grid_whole_frame"].append(_frame_diff(img, whole_frame))
            out["render_max_abs_diff"] = max(errs)
            log(f"  grid expansion, sharded against the whole frame (another sort at "
                f"ties, logged): {out['grid_whole_frame']}")
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
            single = make_render_fn(TrainConfig(settings=compact, extent=3.0), with_stats=True,
                                    eager=True)
            out["compact_whole_frame"] = [_frame_diff(img, single(state0, rc, bg)[0])
                                          for (img, _, _), rc in zip(frames, rcams)]
            with strips_on_one_device(world):
                out["compact"] = [_tie_diff(img, single(state0, rc, bg)[0], int(dropped))
                                  for (img, _, dropped), rc in zip(frames, rcams)]
            log(f"  compact expansion, sharded against single: {out['compact']}; against "
                f"the whole frame (logged): {out['compact_whole_frame']}")

    # SHARD_STEPS sharded steps against as many single-device steps
    order = [i % len(rcams) for i in range(SHARD_STEPS)]
    local = shard_gaussian_state(state0, mesh)
    opt = tx.init(local.params)
    step = make_sharded_train_step(tx, mesh, cams, images, cfg)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    launched = launch_counts()
    ms, step_ms = [], []
    for i, c in enumerate(order):
        (local, opt, m), t = timed(lambda c=c: step(local, opt, [c]))
        ms.append({k: float(v) for k, v in m.items()})
        step_ms.append(t)
        if i == 0:  # the first step's gradients, as 0.1 x in Adam's first moment
            mu_first = gather_moments(opt, mesh)[0]
    out["step_launches"] = global_to_host_local(torch.tensor(list(launches_since(
        launched, ("composite_infer", "composite_fwd", "composite_bwd")).values()))).tolist()
    out["step_ms"] = step_ms
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
    out["losses"] = [m["loss"] for m in ms]
    out["step_dropped"] = [int(m["num_dropped_pairs"]) for m in ms]
    whole = gather_gaussian_state(local, mesh)
    del local, opt
    if main:
        st = _clone_state(state0)
        o1 = tx.init(st.params)
        step1 = make_train_step(tx, cams, images, cfg, eager=True)
        for i, c in enumerate(order):
            with strips_on_one_device(world):
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
                _, _, m1 = make_train_step(tx, cams, images, cfg, eager=True)(
                    st, tx.init(st.params), c)
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
    the same finite losses of both scenes, and the two snapshots are finite.
    The scenes draw their cameras in turn from one generator, as gsjax's
    do, so the same scene trains on other cameras in each slot: the
    snapshots' difference is reported."""
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
    plys = [read_ply(os.path.join(m, "point_cloud", f"iteration_{iterations}",
                                  "point_cloud.ply"))["vertex"] for m in models]
    finite = all(np.isfinite(v).all() for p in plys for v in p.values())
    worst = max(float(np.max(np.abs(plys[0][k] - plys[1][k])
                             / np.maximum(np.abs(plys[1][k]), 1e-30))) for k in plys[1])
    log(f"  losses {[d['losses'] for d in done]}, launches {[d['launches'] for d in done]}, "
        f"wall {[d['wall_s'] for d in done]} s; snapshots finite: {finite}, max relative "
        f"difference between the two scenes {worst:.3e}; {time.perf_counter() - t0:.1f} s")
    if not (finite and all(np.isfinite(d["losses"]).all() for d in done)
            and done[0]["losses"] == done[1]["losses"]):
        raise AssertionError(f"multi-scene: non-finite or disagreeing results {done}")
    return {"max_rel": worst}


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


def phase_knn(scene, n_bench=1_000_000):
    """14a: ``gsjax_torch.native.knn_mean_sq_dist`` on phase 11's sparse
    cloud and on the 1M-gaussian bench scene's centres against scipy's
    cKDTree (the k = 3 nearest, squared, averaged); one and two points give
    0 and their exact distance. Returns the host seconds at 1M."""
    from scipy.spatial import cKDTree

    from gsjax_torch.bench_scene import toy_state
    from gsjax_torch.data.ply import read_point_cloud_ply
    from gsjax_torch.native import knn_mean_sq_dist

    sparse = read_point_cloud_ply(os.path.join(scene, "sparse", "0", "points3D.ply"))[0]
    bench = toy_state(n_bench, 1 << (n_bench - 1).bit_length(), log_scale=-5.2,
                      device="cpu").params["xyz"]
    host_s = None
    for name, pts in (("sparse", np.asarray(sparse, np.float32)),
                      ("bench", bench[:n_bench].numpy())):
        t0 = time.perf_counter()
        got = knn_mean_sq_dist(pts)
        dt = time.perf_counter() - t0
        d, _ = cKDTree(pts).query(pts, k=4, workers=-1)
        want = (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)
        rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
        log(f"  14a kNN of {len(pts)} {name} points: {dt:.3f} s on the host "
            f"({os.cpu_count()} CPUs), max relative difference to cKDTree {rel:.3e}")
        np.testing.assert_allclose(got, want, rtol=KNN_RTOL, atol=KNN_ATOL, err_msg=name)
        host_s = dt
    one = knn_mean_sq_dist(np.zeros((1, 3), np.float32)).tolist()
    two = knn_mean_sq_dist(np.array([[0, 0, 0], [1, 2, 2]], np.float32)).tolist()
    if one != [0.0] or two != [9.0, 9.0]:
        raise AssertionError(f"kNN of one and two points: {one}, {two}")
    log(f"  14a one point {one}, two points {two}")
    return host_s


def _scaled_scene(model_path, device, views, w, h):
    """The scaled model and its first ``views`` test cameras at w x h (the
    horizontal field of view kept), as render_bench --at_1080p loads them."""
    import dataclasses

    from gsjax_torch.configs import ModelParams, load_cfg_args
    from gsjax_torch.train.scene import Scene

    saved = load_cfg_args(model_path)
    model = ModelParams(source_path=saved["source_path"], model_path=model_path, eval=True,
                        sh_degree=saved.get("sh_degree", 3))
    scene = Scene(model, load_iteration=-1, shuffle=False, device=device)
    cams = (scene.get_test_cameras() or scene.get_train_cameras())[:views]
    for i, c in enumerate(cams):
        fov_y = 2 * np.arctan(np.tan(c.fov_x / 2) * h / w)
        cams[i] = dataclasses.replace(c, width=w, height=h, fov_y=float(fov_y))
    return scene.gaussians, cams


def phase_scaled_model(device, run, target=SCALE_TARGET, w=1920, h=1080,
                       views=SCALED_VIEWS, benches=True):
    """14b: ``python -m gsjax_torch.scale_model`` on phase 11's trained
    model to SCALE_TARGET gaussians; in process, its first test views at
    1080p through make_render_fn (no pair dropped, composite_infer once a
    view, the peak memory), one frame's phases and composite_infer against
    its plain version at phase 3's tiers; then ``render_bench --at_1080p``
    and ``viewer_bench`` on it (``benches``). Returns (launches, kernel
    error, numbers)."""
    import dataclasses

    import torch

    from gsjax_torch.ops.cuda_composite import composite_infer_plain
    from gsjax_torch.ops.projection import num_tiles
    from gsjax_torch.train.loop import probe_rasterize_settings
    from gsjax_torch.train.step import TrainConfig, make_render_fn
    from gsjax_torch.utils.profiling import launches as launch_counts, launches_since

    lines = run_module("14b", ["gsjax_torch.scale_model", "-m", run["model"],
                               "--target", str(target)])
    meta = json.loads(lines[-2])
    if meta["n_out"] < target or meta["k"] != -(-target // meta["n_src"]):
        raise AssertionError(f"scale_model: {meta}")
    scaled = run["model"].rstrip("/") + f"_x{meta['k']}"

    state, cams = _scaled_scene(scaled, device, views, w, h)
    if int(state.num_active) != meta["n_out"]:
        raise AssertionError(f"the scaled model loads {int(state.num_active)} gaussians")
    settings = dataclasses.replace(probe_rasterize_settings(state, cams, w, h,
                                                            every_view=True),
                                   backend="kernel")
    render_fn = make_render_fn(TrainConfig(settings=settings), with_stats=True)
    bg = torch.zeros(3, device=device)
    rcams = [c.to_render_camera(device) for c in cams]
    with torch.no_grad():
        render_fn(state, rcams[0], bg)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in rcams]
        launched = launch_counts()
        outs = []
        for (a, z), rc in zip(ev, rcams):
            a.record()
            outs.append(render_fn(state, rc, bg))
            z.record()
        torch.cuda.synchronize()
        launches = launches_since(launched, ("composite_infer",))["composite_infer"]
        frames = [a.elapsed_time(z) for a, z in ev]
        peak = torch.cuda.max_memory_allocated() / 2**30
        for img, dropped in outs:
            if int(dropped) or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"scaled model: {int(dropped)} pairs dropped or non-finite")
        phases, cache = frame_phase_ms(state, rcams[0], settings, bg)
        b = cache["bins"]
        tx, ty = num_tiles(w, h)
        args = (b.tile_start, b.pair_gauss, cache["attrs"], tx, ty)
        kc, kT = cache["out"]
        pc, pT = composite_infer_plain(*args)
        torch.cuda.synchronize()
        err = max(compare(f"scaled {w}x{h} tile_colors", kc, pc),
                  compare(f"scaled {w}x{h} tile_T", kT, pT))
    nums = {"n": meta["n_out"], "k": meta["k"], "max_pairs": settings.max_pairs,
            "pairs": int(b.num_pairs), "deepest_tile_pairs": deepest_tile(b.tile_start),
            "mt": settings.max_tiles_per_gauss,
            "expansion": settings.expansion, "frame_ms": frames, "peak_memory_gib": peak,
            "phases_ms": phases}
    log(f"  14b {meta['n_out']} gaussians (x{meta['k']}): {json.dumps(nums)}; composite_infer "
        f"launched {launches} times for {len(rcams)} views")
    del state, cache, outs, kc, kT, pc, pT
    torch.cuda.empty_cache()
    if launches != len(rcams):
        raise AssertionError(f"composite_infer launched {launches} times for {len(rcams)} views")
    if not benches:
        return launches, err, nums

    result = json.loads(run_module("14b", ["gsjax_torch.render_bench", "-m", scaled,
                                           "--at_1080p", "--views", str(views),
                                           "--device", device])[-1])
    if result["extra"]["num_dropped"] != 0 or not result["value"] > 0:
        raise AssertionError(f"render_bench on the scaled model: {result}")
    lines = run_module("14b", ["gsjax_torch.viewer_bench", "-m", scaled, "--width", "1920",
                               "--height", "1080", "--frames", "60", "--port", "0",
                               "--device", device])
    report = json.loads("\n".join(lines[lines.index("{"):]))
    nums.update(fps=result["value"], viewer_p50_ms=report["p50_ms"],
                viewer_p90_ms=report["p90_ms"])
    log(f"  14b render_bench {result['value']} frames/s at {result['extra']['resolution']} "
        f"(max_pairs {result['extra']['max_pairs']}, {result['extra']['n_gaussians']} "
        f"gaussians); viewer_bench p50 {report['p50_ms']} ms, p90 {report['p90_ms']} ms")
    return launches, err, nums


def _arm_log(path):
    with open(os.path.join(path, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_drop_ab(device, run, workdir, iters=DROP_ITERS):
    """14c: ``python -m gsjax_torch.drop_ab`` from phase 11's checkpoint at
    its half, ``iters`` iterations an arm: the baseline arm's pair budget at
    DROP_MULT_BASELINE of the probe's overflows (its ``pair_overflow``
    records: the trainer doubles the budget, so the drops last one
    dispatch, and the records of ``dropped_pairs`` every 100 iterations
    read 0), the big arm's at DROP_MULT does not, both PSNRs finite, the
    kernels once per step. Returns the arms' last lines."""
    out = os.path.join(workdir, "drop_ab.json")
    start = run["checkpoint_iter"]
    lines = run_module("14c", ["gsjax_torch.drop_ab", "-s", run["scene"], "-m", run["model"],
                               "--from_iter", str(start), "--to_iter", str(start + iters),
                               "--mult_baseline", str(DROP_MULT_BASELINE),
                               "--mult", str(DROP_MULT), "--out", out, "--device", device])
    with open(out) as f:
        report = json.load(f)
    done = [json.loads(line) for line in lines if line.startswith('{"stage": "done"')]
    arms = {}
    for arm in ("baseline", "big_budget"):
        recs = _arm_log(run["model"].rstrip("/") + f"_dropab_{arm}")
        overflow = [r for r in recs if r.get("event") == "pair_overflow"]
        a = report["arms"][arm]
        arms[arm] = {"psnr": a["results"][f"ours_{start + iters}"]["PSNR"],
                     "mean_dropped_pairs": a.get("mean_dropped_pairs"),
                     "max_dropped_pairs": a.get("max_dropped_pairs"),
                     "budget_dropped": sum(r["budget_dropped"] for r in overflow),
                     "mt_capped": sum(r["mt_capped"] for r in overflow),
                     "overflow_events": len(overflow),
                     "mean_it_per_s": a.get("mean_it_per_s")}
    log(f"  14c arms {json.dumps(arms)}; psnr_cost_of_drops {report.get('psnr_cost_of_drops')}; "
        f"launches {[d['launches'] for d in done]}")
    b, g = arms["baseline"], arms["big_budget"]
    checks = {
        "the baseline arm's budget overflowed": b["budget_dropped"] > 0,
        "the big arm's did not": g["budget_dropped"] == 0 and g["max_dropped_pairs"] == 0,
        "both PSNRs finite": all(np.isfinite(x["psnr"]) for x in arms.values()),
        "fwd and bwd once per step in each arm": device != "cuda" or all(
            d["launches"]["composite_fwd"] == iters
            and d["launches"]["composite_bwd"] == iters for d in done) and len(done) == 2,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"drop_ab: {failed}")
    return done


def phase_densify_ab(device, workdir, n=DENSIFY_AB_ITERS, scene_args=()):
    """14d: ``python -m gsjax_torch.densify_grad_ab`` on the script's default
    scene (``scene_args`` change it), ``n`` iterations an arm on phase 11's
    cut schedule: two finite reports; the PSNR gap."""
    out = os.path.join(workdir, "densify_grad_ab.json")
    run_module("14d", ["gsjax_torch.densify_grad_ab", "--scene", os.path.join(workdir, "synth_ab"),
                       "--iterations", str(n), "--densify_from_iter", str(n // 6),
                       "--densification_interval", str(n // 6),
                       "--densify_until_iter", str(2 * n // 3),
                       "--opacity_reset_interval", str(n // 2), "--model_root", workdir,
                       "--out", out, "--device", device, *scene_args])
    with open(out) as f:
        report = json.load(f)
    res = report["results"]
    finite = all(np.isfinite(res[m]["report"][s][k]) for m in ("apply", "discard")
                 for s in ("test", "train") for k in ("psnr", "l1"))
    gap = res["apply"]["report"]["test"]["psnr"] - res["discard"]["report"]["test"]["psnr"]
    log(f"  14d test PSNR apply {res['apply']['report']['test']['psnr']:.4f}, discard "
        f"{res['discard']['report']['test']['psnr']:.4f} (apply - discard {gap:+.4f} dB); "
        f"gaussians {res['apply']['final_gaussians']} / {res['discard']['final_gaussians']}; "
        f"wall {res['apply']['wall_s']} / {res['discard']['wall_s']} s on {report['device']}")
    if not finite:
        raise AssertionError(f"densify_grad_ab: non-finite report {res}")
    return gap


def phase_split(device, workdir, size_args=(), ref_path=SPLIT_REF):
    """14e: ``python -m gsjax_torch.multichip_split --ranks 2`` at gsjax's
    operating point (a2a, the strip budget x1.2; ``size_args`` change the
    scene): every per-rank count within SPLIT_REL of the committed counts of
    gsjax's script (``ref_path``, None to skip)."""
    out = os.path.join(workdir, "split_g2.json")
    report = json.loads(run_module("14e", [
        "gsjax_torch.multichip_split", "--ranks", "2", "--exchange", "a2a",
        "--strip_budget_mult", "1.2", "--out", out, "--device", device, *size_args])[-1])
    log(f"  14e balance {report['balance']}; projection {json.dumps(report.get('projection'))}")
    if ref_path is None:
        return report
    with open(os.path.join(HERE, ref_path)) as f:
        ref = json.load(f)
    diffs, bad = [], []
    for r, (got, want) in enumerate(zip(report["per_chip"], ref["per_chip"])):
        for k, v in want.items():
            d = got[k] - v
            diffs.append((r, k, got[k], v, d))
            if abs(d) > SPLIT_REL * abs(v):
                bad.append((r, k, got[k], v))
    op, rop = report["operating_point"], ref["operating_point"]
    if (op["max_pairs_per_strip"], op["strips_y"]) != (rop["max_pairs_per_strip"],
                                                       rop["strips_y"]):
        bad.append(("operating point", op, rop))
    log("  14e per rank (count, gsjax's, difference): " + "; ".join(
        f"[{r}] {k} {g} / {w} ({d:+d})" for r, k, g, w, d in diffs))
    if bad or len(report["per_chip"]) != len(ref["per_chip"]):
        raise AssertionError(f"multichip_split: counts beyond {SPLIT_REL:.0e} of {ref_path}: "
                             f"{bad}")
    return report


def phase_adam_card(device):
    """14f: the port's Adam (optax's float32 update) on the card equals its
    run on the CPU bit for bit, over three steps and a count set apart, so
    the card keeps the equality with gsjax that the CPU tests hold."""
    import torch

    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.train.optim import adam_moments, make_optimizer, with_adam_moments

    rng = np.random.default_rng(0)
    n = 200_000
    shapes = {"xyz": (n, 3), "features_dc": (n, 1, 3), "features_rest": (n, 15, 3),
              "scaling": (n, 3), "rotation": (n, 4), "opacity": (n, 1)}
    p0 = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1e-3, s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    runs = {}
    for dev in (device, "cpu"):
        params = {k: torch.from_numpy(v.copy()).to(dev) for k, v in p0.items()}
        opt = make_optimizer(OptimizationParams(), 2.5).init(params)
        for i, g in enumerate(grads):
            for k, v in params.items():
                v.grad = torch.from_numpy(g[k]).to(dev)
            opt.step()
            if i == 1:
                opt = with_adam_moments(opt, *adam_moments(opt), count=17)
        mu, nu = adam_moments(opt)
        runs[dev] = {**{f"p_{k}": v.detach().cpu() for k, v in params.items()},
                     **{f"mu_{k}": v.cpu() for k, v in mu.items()},
                     **{f"nu_{k}": v.cpu() for k, v in nu.items()}}
    off = {k: int((runs[device][k] != v).sum()) for k, v in runs["cpu"].items()}
    log(f"  14f Adam on {device} against the CPU, elements that differ: "
        f"{sum(off.values())} of {sum(v.numel() for v in runs['cpu'].values())}")
    if any(off.values()):
        raise AssertionError(f"Adam on the card differs from the CPU: {off}")


def _ulp_diff(a, b) -> int:
    """Largest distance of two float32 tensors in units in the last place
    (their bit patterns as signed integers, sign-magnitude folded)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def phase_prng_draws(device):
    """15a: the port's ``utils.prng`` draws on the card against the same
    draws on the CPU (bits and uniforms bit for bit, normals within
    NORMAL_ULP), then the split noise's and a random background's times.
    Returns the times."""
    import torch

    from gsjax_torch.utils import prng

    worst = {"bits": 0, "uniform": 0, "normal": 0}
    for seed in (0, 1, 2**31 - 1):
        key = prng.fold_in(prng.split(prng.PRNGKey(seed))[1], 7)
        for shape in PRNG_SHAPES:
            for fn in (prng.bits, prng.uniform, prng.normal):
                got, want = fn(key, shape, device), fn(key, shape, "cpu")
                if got.device.type != torch.device(device).type:
                    raise AssertionError(f"prng.{fn.__name__} drew on {got.device}")
                got = got.cpu()
                d = (int((got - want).abs().max()) if fn is prng.bits
                     else _ulp_diff(got, want))
                worst[fn.__name__] = max(worst[fn.__name__], d)
    log(f"  15a card against CPU over 3 keys x shapes {PRNG_SHAPES}: bits max |diff| "
        f"{worst['bits']}, uniforms {worst['uniform']} ulp, normals {worst['normal']} ulp "
        f"(tolerance {NORMAL_ULP} ulp)")
    if worst["bits"] or worst["uniform"] or worst["normal"] > NORMAL_ULP:
        raise AssertionError(f"prng draws on the card differ from the CPU's: {worst}")

    key = prng.PRNGKey(0)
    noise = PRNG_SHAPES[-1]
    times = {"split_noise_ms": time_cuda(lambda: prng.normal(key, noise, device), 5),
             "randn_ms": time_cuda(lambda: torch.randn(noise, device=device), 5),
             "background_ms": time_cuda(lambda: prng.uniform(key, (3,), device), 50)}
    # a random background's host side a step: fold_in and the draw's launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(50):
        prng.uniform(prng.fold_in(key, i), (3,), device)
    times["background_host_ms"] = (time.perf_counter() - t0) * 1e3 / 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1000):
        prng.split(prng.fold_in(key, i))
    times["split_fold_in_host_us"] = (time.perf_counter() - t0) * 1e3
    log(f"  15a split noise {noise} {times['split_noise_ms']:.3f} ms (torch.randn "
        f"{times['randn_ms']:.3f}); a random background {times['background_ms']:.4f} ms a "
        f"draw by CUDA events over back-to-back draws, {times['background_host_ms']:.4f} ms "
        f"of host with its fold_in; a key split + fold_in {times['split_fold_in_host_us']:.2f} "
        f"us of host")
    return times


def phase_prng_run(device, run, workdir, iterations=PRNG_RUN_ITERS):
    """15b: ``python -m gsjax_torch.train --random_background`` on phase
    11's scene at the default percent_dense: it splits (the noise and every
    step's background from gsjax's keys), launches the training kernels
    once a step and ``composite_infer`` once an evaluated view, and ends
    with a finite test PSNR. Returns its summary."""
    every = iterations // 4
    done, records = _train_run("15b", run["scene"], os.path.join(workdir, "random_bg"), device, [
        "--iterations", str(iterations), "--random_background",
        "--densify_from_iter", str(every), "--densification_interval", str(every),
        "--densify_until_iter", str(iterations - every // 2),
        "--test_iterations", str(iterations), "--capacity", str(run["capacity"])])
    dens = [r for r in records if r.get("event") == "densify"]
    evals = [r["eval"] for r in records if "eval" in r]
    n_eval = sum(e[s]["n_views"] for e in evals for s in ("test", "train"))
    want = {"composite_fwd": iterations, "composite_bwd": iterations, "composite_infer": n_eval}
    psnr = evals[-1]["test"]["psnr"] if evals else float("nan")
    progress = [r for r in records if "it_per_s" in r]
    log(f"  15b densify events {[(r['iter'], r['cloned'], r['split'], r['num_active']) for r in dens]} "
        f"(iteration, cloned, split, active); test PSNR {psnr}; it/s "
        f"{[round(r['it_per_s'], 2) for r in progress]}; wall {done['wall_s']:.1f} s; launches "
        f"{done['launches']} (want {want})")
    checks = {
        "densify events with splits": bool(dens) and sum(r["split"] for r in dens) > 0,
        "a finite test PSNR": bool(evals) and np.isfinite(psnr),
        "launches: fwd and bwd once per step, infer once per eval view":
            device != "cuda" or done["launches"] == want,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"random-background run: {failed}")
    return {"psnr": psnr, "densify": {r["iter"]: (r["split"], r["num_active"]) for r in dens},
            "wall_s": done["wall_s"]}


def phase_prng(device, run, workdir):
    """Phase 15 (see the module docstring)."""
    t0 = time.perf_counter()
    log("phase 15: gsjax's random keys on the card")
    times = phase_prng_draws(device)
    summary = phase_prng_run(device, run, workdir)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return {**times, **summary}


def phase_last_modules(device, run, workdir):
    """Phase 14 (see the module docstring). Returns composite_infer's
    launches and error on the scaled model, and the A/B arms' launches."""
    t0 = time.perf_counter()
    times = {}

    def sub(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        times[name] = round(time.perf_counter() - t, 1)
        log(f"  {name}: {times[name]} s")
        return out

    log("phase 14: the last modules (native kNN, scale_model, the quality A/Bs, "
        "multichip_split)")
    sub("14a", phase_knn, run["scene"])
    launches, err, nums = sub("14b", phase_scaled_model, device, run)
    done = sub("14c", phase_drop_ab, device, run, workdir)
    sub("14d", phase_densify_ab, device, workdir)
    sub("14e", phase_split, device, workdir)
    sub("14f", phase_adam_card, device)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s ({times})")
    return {"scaled": (launches, err), "ab": done, "deepest_tile": nums["deepest_tile_pairs"]}


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
        from gsjax_torch.ops import kernels
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
    kernels.load_library(verbose=True)
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    device = "cuda"
    errs512, ts512 = phase_compare(device)
    entries, state, rcams, settings, ts1080 = main_path(device)
    launches = train_path(device, state, rcams, settings)
    for e, err512, n_launch in zip(entries, errs512, (None,) + launches[1:3]):
        e["max_abs_err"] = max(e["max_abs_err"], err512)
        if n_launch is not None:
            e["launches"] = n_launch
    entries[2]["launches_bf16"] = launches[3]
    entries[4]["launches"] = launches[4]
    del state
    phase_scan_vs_kernel(device)
    phase_cli(device)

    probe_err, probe_times = phase_probe({"entry512": ts512, "bench1080": ts1080})
    probe_launches = phase_probes()
    if probe_launches["sol_probe"] == 0:
        raise AssertionError(f"the probe path launched no sol_probe: {probe_launches}")
    # the slope's heaviest configuration at the first port's occupancy
    ms, plain, bound, by = probe_times[((40, 0), 8)]
    entries.append({
        "name": "sol_probe", "route": "cuda", "source": "gsjax_torch/csrc/sol_probe.cu",
        "replaces": "scripts/_r4_session.py:321, scripts/_r5_session.py:327",
        "launches": probe_launches["sol_probe"], "max_abs_err": probe_err,
        "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None,  # no single PyTorch call computes this
        "configs": {f"k_ops={k[0]},k_exp={k[1]},warps_per_sm={w}": {
            "ms": t[0], "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3]}
            for (k, w), t in probe_times.items()},
    })
    phase_bench()
    with tempfile.TemporaryDirectory() as tmp:
        run = phase_training_run(device, workdir=tmp)
        entries[0]["launches_serving"] = phase_serving(device, run["model"], 600, settings)
        sharded = phase_sharded(device, run, tmp)
        last = phase_last_modules(device, run, tmp)
        phase_prng(device, run, tmp)
    for e in entries[:3]:  # the compositing kernels in 13a: launches, error on a strip
        e["launches_sharded"], e["max_abs_err_sharded"] = sharded[e["name"]]
        e["max_abs_err"] = max(e["max_abs_err"], e["max_abs_err_sharded"])
    # phase 14: composite_infer on the scaled model's 1080p views, the
    # training kernels in the drop A/B's two arms
    entries[0]["launches_scaled"], entries[0]["max_abs_err_scaled"] = last["scaled"]
    entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"], last["scaled"][1])
    for e in entries[:3]:
        e["deepest_tile_pairs_scaled1m"] = last["deepest_tile"]
    for e in entries[1:3]:
        e["launches_drop_ab"] = sum(d["launches"][e["name"]] for d in last["ab"])

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
