"""Multi-scene parallel training: ``python -m gsjax_torch.train_multiscene``.

Counterpart of the root ``train_multiscene.py``. The reference trains a
benchmark suite's scenes one after another (reference full_eval.py:39-52);
here the world's ranks split into one equal group per scene
(``parallel.multi_scene``), every rank trains its scene, and there is no
cross-scene collective. Each rank loads and saves only its own scene
(one rank of each scene's group writes). Start one process per rank with
``--dist_coordinator HOST:PORT --dist_num_processes N --dist_process_id
I`` (or the ``GSJAX_*`` variables), or ``--multihost`` under torchrun; a
single process trains one scene. Example (2 scenes on 2 ranks, rank 0):

    python -m gsjax_torch.train_multiscene -s sceneA sceneB -m out/A out/B \\
        --iterations 30000 --dist_coordinator 127.0.0.1:29500 \\
        --dist_num_processes 2 --dist_process_id 0

The flags are the root script's plus ``--device`` (default ``cuda``). As
there, the scenes share one resolution, the densify thresholds use the
largest scene extent, and the capacity is fixed (densification drops what
does not fit), and the scenes draw their cameras in turn from one numpy
generator seeded by ``--seed`` (:func:`sample_camera_indices`). The random
keys are gsjax's (``utils.prng``, :func:`dispatch_keys`,
:func:`densify_keys`): a dispatch at iteration ``it`` gives every scene
``fold_in(PRNGKey(seed), it)``, and a densification there gives scene
``s`` ``fold_in(fold_in(PRNGKey(seed), it), s)``. The last line of each
rank's output is one JSON object: its scene, the per-scene losses of the
last dispatch, the wall time and the compositing kernels' launch counts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from gsjax_torch.utils import prng


def build_parser():
    parser = argparse.ArgumentParser(description="gsjax_torch multi-scene training")
    parser.add_argument("-s", "--source_paths", nargs="+", required=True)
    parser.add_argument("-m", "--model_paths", nargs="+", default=None)
    parser.add_argument("--iterations", type=int, default=30_000)
    parser.add_argument("--capacity", type=int, default=None)
    parser.add_argument("--white_background", "-w", action="store_true")
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--images", type=str, default="images")
    parser.add_argument("--resolution", "-r", type=int, default=-1)
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--steps_per_dispatch", type=int, default=25)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument("--dist_coordinator", type=str, default=None)
    parser.add_argument("--dist_num_processes", type=int, default=None)
    parser.add_argument("--dist_process_id", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return parser


def sample_camera_indices(rng, cam_counts, n: int) -> np.ndarray:
    """(S, n) camera indices for the next ``n`` steps: each scene's ``n``
    draws from its own camera count, the scenes in turn from the one
    generator ``rng`` (gsjax's ``train_multiscene.py:208-214``)."""
    return np.stack([rng.integers(0, cam_counts[s], size=n) for s in range(len(cam_counts))])


def dispatch_keys(key, it: int, n_scenes: int) -> np.ndarray:
    """(S, 2) keys of the dispatch that starts after iteration ``it``: the
    same ``fold_in(key, it)`` for every scene (gsjax's
    ``train_multiscene.py:251-256``)."""
    return np.stack([prng.fold_in(key, it)] * n_scenes)


def densify_keys(key, it: int, n_scenes: int) -> np.ndarray:
    """(S, 2) split-noise keys of the densification at ``it``: scene ``s``
    takes ``fold_in(fold_in(key, it), s)`` (gsjax's
    ``train_multiscene.py:271-272``)."""
    return np.stack([prng.fold_in(prng.fold_in(key, it), s) for s in range(n_scenes)])


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    args.save_iterations = sorted(set(args.save_iterations) | {args.iterations})

    import random

    import torch

    from gsjax_torch.configs import ModelParams, OptimizationParams
    from gsjax_torch.data.cameras import stack_render_cameras
    from gsjax_torch.models.gaussians import grow_capacity
    from gsjax_torch.parallel.multi_scene import (
        local_scene_ids,
        local_scene_state,
        make_multi_scene_densify_step,
        make_multi_scene_train_step_chained,
        make_scene_mesh,
        scene_values,
    )
    from gsjax_torch.parallel.multihost import (
        global_to_host_local,
        is_main_process,
        maybe_initialize,
        rank_device,
    )
    from gsjax_torch.train.loop import default_rasterize_settings
    from gsjax_torch.train.optim import make_optimizer
    from gsjax_torch.train.scene import Scene
    from gsjax_torch.train.step import TrainConfig, stack_images
    from gsjax_torch.utils.profiling import launches, launches_since

    rank_device(args.device)  # fail before loading anything
    maybe_initialize(args.dist_coordinator, args.dist_num_processes, args.dist_process_id,
                     args.multihost, device=args.device)
    dev = rank_device(args.device)
    quiet = args.quiet or not is_main_process()

    def log(*a):
        if not quiet:
            print(*a, flush=True)

    sources = args.source_paths
    n_scenes = len(sources)
    model_paths = args.model_paths or [
        os.path.join("./output", os.path.basename(s.rstrip("/"))) for s in sources]
    if len(model_paths) != n_scenes:
        parser.error("need one model path per source path")

    mesh = make_scene_mesh(n_scenes)
    (sid,) = local_scene_ids(mesh, n_scenes)
    writer = mesh.inner == 0  # one rank of each scene's group writes
    log(f"[multi-scene] {n_scenes} scenes on {mesh.n_scenes * mesh.per} ranks; rank "
        f"{mesh.scene * mesh.per + mesh.inner} trains scene {sid}")

    opt = OptimizationParams(iterations=args.iterations)
    random.seed(args.seed)
    np.random.seed(args.seed)

    # --- load this rank's scene (the others never touch its disk) ---
    model = ModelParams(source_path=sources[sid], model_path=model_paths[sid],
                        images=args.images, resolution=args.resolution,
                        white_background=args.white_background, eval=args.eval,
                        sh_degree=args.sh_degree)
    if writer:
        os.makedirs(model.model_path, exist_ok=True)
    sc = Scene(model, capacity=args.capacity, device=dev, write_model_dir=writer)
    cams = sc.get_train_cameras()
    sizes = {(c.width, c.height) for c in cams}
    if len(sizes) != 1:
        raise ValueError(f"scene {sources[sid]} has mixed resolutions {sizes}; multi-scene "
                         "training needs one size per scene (use gsjax_torch.train for "
                         "mixed-resolution scenes)")

    # --- agree on the shared static values across ranks ---
    mine = torch.tensor([len(cams), *next(iter(sizes)), sc.gaussians.capacity,
                         float(sc.cameras_extent)], dtype=torch.float64)
    every = global_to_host_local(mine)[::mesh.per]  # (S, 5), one row per scene
    cam_counts = every[:, 0].astype(np.int64)
    shapes = {(int(w), int(h)) for w, h in every[:, 1:3]}
    if len(shapes) != 1:
        raise ValueError(f"scenes disagree on resolution: {shapes}")
    width, height = next(iter(shapes))
    capacity = int(every[:, 3].max())  # all scenes share capacity
    state = sc.gaussians
    if state.capacity < capacity:
        state = grow_capacity(state, capacity)

    settings = default_rasterize_settings(width, height, capacity)
    # the densify thresholds scale with the extent: the largest (conservative
    # for smaller scenes), as gsjax's one static TrainConfig.extent
    cfg = TrainConfig(settings=settings, lambda_dssim=opt.lambda_dssim,
                      white_background=args.white_background,
                      random_background=opt.random_background, extent=float(every[:, 4].max()))
    tx = make_optimizer(opt, float(state.spatial_lr_scale))
    opt_state = tx.init(state.params)
    cam_batch = stack_render_cameras(cams, dev)
    images = torch.from_numpy(stack_images(cams)).to(dev)

    n_chain = max(1, args.steps_per_dispatch)
    steps = {}  # one chained step per dispatch length (event spacing rarely divides n_chain)

    def step_of(n):
        if n not in steps:
            steps[n] = make_multi_scene_train_step_chained(tx, cam_batch, images, cfg, mesh, n)
        return steps[n]

    densify_step, reset_step = make_multi_scene_densify_step(opt, cfg, mesh)

    # camera sampling: every rank draws the same (S, n) indices from one
    # generator, the scenes in turn, as gsjax does
    rng = np.random.default_rng(args.seed)
    key = prng.PRNGKey(args.seed)

    def sample_idx(n):
        return sample_camera_indices(rng, cam_counts, n)

    events = sorted(e for e in (
        {args.iterations} | set(args.save_iterations)
        | set(range(opt.densify_from_iter, opt.densify_until_iter, opt.densification_interval))
        | set(range(opt.opacity_reset_interval, args.iterations, opt.opacity_reset_interval))
    ) if e <= args.iterations)

    launched = launches()
    t0 = time.time()
    it = 0
    losses = None
    for ev in events:
        while it < ev:
            n = min(n_chain, ev - it)
            state, opt_state, metrics = step_of(n)(state, opt_state, sample_idx(n),
                                                   dispatch_keys(key, it, n_scenes))
            it += n
        losses = scene_values(metrics["loss_mean"], mesh)
        rate = it / max(time.time() - t0, 1e-9)
        log(f"[{it:>6}] loss/scene={np.array2string(losses, precision=4)} "
            f"({rate:.1f} it/s/scene)")

        in_densify = (opt.densify_from_iter < it < opt.densify_until_iter
                      and it % opt.densification_interval == 0)
        if in_densify:
            state, opt_state, _ = densify_step(state, opt_state, densify_keys(key, it, n_scenes),
                                               it > opt.opacity_reset_interval)
        if it % opt.opacity_reset_interval == 0 and it < args.iterations:
            state, opt_state = reset_step(state, opt_state)
        if it in args.save_iterations and writer:
            st = local_scene_state(state, sid, mesh, n_scenes)
            sc.save(it, st)
            print(f"  saved scene {sid} at iteration {it} ({int(st.num_active)} gaussians)",
                  flush=True)

    wall = time.time() - t0
    log(f"multi-scene training complete: {args.iterations} iterations x {n_scenes} scenes "
        f"in {wall:.1f}s")
    print(json.dumps({"stage": "done", "scene": sid, "iterations": args.iterations,
                      "losses": [float(v) for v in losses], "wall_s": wall,
                      "num_active": int(state.num_active),
                      "launches": launches_since(launched, (
                          "composite_infer", "composite_fwd", "composite_bwd"))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
