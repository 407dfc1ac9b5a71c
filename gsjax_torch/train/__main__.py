"""Training entry point of the port: ``python -m gsjax_torch.train``.

The root ``train.py``'s flags (reference train.py:193-222) plus
``--device`` (default ``cuda``; ``--device cpu`` runs the kernels' plain
versions). Example:

    python -m gsjax_torch.train -s /data/nerf_synthetic/lego --eval

As gsjax's, the run serves the SIBR remote-viewer bridge on ``--ip`` /
``--port`` unless ``--disable_viewer`` is given (a port it cannot bind
prints "viewer bridge disabled" and training goes on; the bridge runs one
step per dispatch), and ``--web_viewer PORT`` serves the live state to a
browser (``gsjax_torch.viewer.local_viewer``).

``--data_shards`` x ``--gauss_shards`` ranks train one scene sharded
(``gsjax_torch.parallel``), one process each, started with the root
``train.py``'s bootstrap flags: ``--dist_coordinator HOST:PORT
--dist_num_processes N --dist_process_id I`` (or the ``GSJAX_*``
variables), or ``--multihost`` under ``torchrun``. Only rank 0 logs,
evaluates and saves; the others run quiet. A sharded run serves no viewer
(the bridge would step one rank alone): ``--web_viewer`` is refused and
the bridge is off.

On its last line the CLI prints one JSON object with the iterations run,
the compositing kernels' launch counts over the run (this rank's; with
``bwd_launches_bf16``, those of the backward's bf16 instances, which the
default settings' ``grad_dtype="bfloat16"`` selects on CUDA), the steps
each path ran (``step_paths``: replayed CUDA graphs, graph warm-ups, eager;
see ``train.loop``), the CUDA graphs captured and the host seconds their
captures took (``graph_captures``: steps, dispatches and renders), its
wall time and, on CUDA, the peak device memory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np


def build_parser():
    from gsjax_torch.configs import ModelParams, OptimizationParams, PipelineParams, add_group

    parser = argparse.ArgumentParser(description="gsjax_torch training")
    add_group(parser, ModelParams, "Model Parameters")
    add_group(parser, OptimizationParams, "Optimization Parameters")
    add_group(parser, PipelineParams, "Pipeline Parameters")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--capacity", type=int, default=None,
                        help="initial gaussian buffer capacity (grows 2x as needed)")
    parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--web_viewer", type=int, default=None, metavar="PORT",
                        help="serve a live local web viewer of the training run "
                             "on this port (0 = any free port)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler trace of the first 100 "
                             "iterations to DIR/trace.json")
    parser.add_argument(
        "--densify_iter_grad", choices=("apply", "discard"), default="apply",
        help="densify-iteration gradient semantics: 'discard' matches the "
        "reference exactly (its optimizer surgery drops that step's update, "
        "reference train.py:118-128); 'apply' (default) applies every step",
    )
    parser.add_argument("--wall_budget", type=float, default=0.0,
                        help="stop after this many seconds with a checkpoint and "
                             "a PLY snapshot (resumable via --start_checkpoint); "
                             "0 = no budget")
    parser.add_argument("--steps_per_dispatch", type=int, default=25)
    parser.add_argument("--data_shards", type=int, default=1,
                        help="mesh axis: cameras per step (data parallel)")
    parser.add_argument("--gauss_shards", type=int, default=1,
                        help="mesh axis: gaussian / tile-strip sharding")
    parser.add_argument("--multihost", action="store_true",
                        help="torch.distributed env:// rendezvous (torchrun), one "
                             "process per rank")
    parser.add_argument("--dist_coordinator", type=str, default=None, metavar="HOST:PORT",
                        help="rank 0's address (with --dist_num_processes / "
                             "--dist_process_id)")
    parser.add_argument("--dist_num_processes", type=int, default=None)
    parser.add_argument("--dist_process_id", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda or cpu)")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)

    import torch

    from gsjax_torch.configs import ModelParams, OptimizationParams, PipelineParams, extract
    from gsjax_torch.ops import cuda_composite as cc
    from gsjax_torch.parallel.multihost import is_main_process, maybe_initialize, rank_device
    from gsjax_torch.train.loop import training
    from gsjax_torch.train.step import STEP_PATHS
    from gsjax_torch.utils.graphs import CAPTURES
    from gsjax_torch.utils.system import safe_state

    device = rank_device(args.device)  # fail before loading anything
    distributed = maybe_initialize(args.dist_coordinator, args.dist_num_processes,
                                   args.dist_process_id, args.multihost, device=args.device)
    if distributed or args.data_shards * args.gauss_shards > 1:
        device = rank_device(args.device)
        if args.web_viewer is not None:
            raise ValueError("--web_viewer serves one process's state: not with sharded "
                             "training")
        args.disable_viewer = True
        if not is_main_process():
            args.quiet = True
    if device.type == "cuda":
        torch.cuda.set_device(device)  # this rank's card, with CUDA initialized
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    safe_state(args.quiet, args.seed)  # reference train.py:214

    model = extract(ModelParams, args)
    opt = extract(OptimizationParams, args)
    pipe = extract(PipelineParams, args)
    print(f"Optimizing {model.model_path or '(auto model dir)'}")

    profile = contextlib.ExitStack()
    passives = []
    if args.profile:
        from gsjax_torch.utils.profiling import trace

        profile.enter_context(trace(args.profile))

        def write_trace(iteration, state, render_fn):
            if iteration > 100:
                profile.close()  # writes the trace; a no-op once closed

        passives.append(write_trace)

    viewers = contextlib.ExitStack()  # closed when training returns or raises
    gui_callback = None
    if not args.disable_viewer:
        from gsjax_torch.viewer.network_gui import ViewerBridge

        try:
            bridge = ViewerBridge(args.ip, args.port, model.source_path,
                                  max_iterations=args.iterations)
            viewers.callback(bridge.close)
            gui_callback = bridge.poll
        except OSError as e:
            print(f"viewer bridge disabled: {e}")

    if args.web_viewer is not None:
        # live local web viewer of the training run (headless-friendly
        # SIBR-remote analogue); lazily started once state exists. The
        # state is updated in place, so this thread holds the render lock
        # through each iteration and lets queued renders run between two.
        holder = {}

        def web_viewer(iteration, state, render_fn):
            v = holder.get("v")
            if v is None:
                from gsjax_torch.viewer.local_viewer import LocalViewer

                v = LocalViewer(state, np.full(3, 1.0 if model.white_background else 0.0,
                                               np.float32),
                                port=args.web_viewer, iteration=iteration, device=device)
                v.hold()
                port = v.start()
                print(f"web viewer: http://127.0.0.1:{port}/", flush=True)
                holder["v"] = v
                viewers.callback(v.stop)
                viewers.callback(v.release)  # runs first: a queued render finishes
            v.between_iterations(state, iteration)

        passives.append(web_viewer)

    def passive_callback(iteration, state, render_fn):
        for fn in passives:
            fn(iteration, state, render_fn)

    kernels = (cc.composite_infer, cc.composite_fwd, cc.composite_bwd)
    for k in kernels:
        k.launches = 0
    cc.composite_bwd.launches_bf16 = 0
    STEP_PATHS.update(graph=0, capture=0, eager=0)
    CAPTURES.update(count=0, seconds=0.0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with viewers, profile:
        scene, state = training(
            model, opt, pipe,
            testing_iterations=args.test_iterations,
            saving_iterations=args.save_iterations,
            checkpoint_iterations=args.checkpoint_iterations,
            start_checkpoint=args.start_checkpoint,
            quiet=args.quiet,
            capacity=args.capacity,
            gui_callback=gui_callback,
            passive_callback=passive_callback if passives else None,
            seed=args.seed,
            steps_per_dispatch=args.steps_per_dispatch,
            data_shards=args.data_shards,
            gauss_shards=args.gauss_shards,
            debug_from=args.debug_from,
            densify_iter_grad=args.densify_iter_grad,
            wall_budget=args.wall_budget,
            device=device,
        )
    wall = time.perf_counter() - t0
    print("\nTraining complete.")
    summary = {
        "stage": "done", "rank": torch.distributed.get_rank() if distributed else 0, "iterations": opt.iterations, "wall_s": wall,
        "num_active": int(state.num_active), "capacity": state.capacity,
        "launches": {k.__name__: k.launches for k in kernels},
        # of composite_bwd's launches, those of its bf16 instances (grad_dtype)
        "bwd_launches_bf16": cc.composite_bwd.launches_bf16,
        "step_paths": dict(STEP_PATHS),
        "graph_captures": dict(CAPTURES),
        "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                            if device.type == "cuda" else None),
    }
    sys.stdout.flush()
    sys.__stdout__.write(json.dumps(summary) + "\n")  # past --quiet's silenced stdout
    sys.__stdout__.flush()
    return scene, state


if __name__ == "__main__":
    main(sys.argv[1:])
