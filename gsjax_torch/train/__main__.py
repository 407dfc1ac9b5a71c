"""Training entry point of the port: ``python -m gsjax_torch.train``.

The root ``train.py``'s flags (reference train.py:193-222) plus
``--device`` (default ``cuda``; ``--device cpu`` runs the kernels' plain
versions). Example:

    python -m gsjax_torch.train -s /data/nerf_synthetic/lego --eval

Not ported, each refused when asked for: ``--web_viewer`` (ROADMAP Queue 1
item 5, the viewer) and ``--multihost`` / ``--dist_*`` / ``--data_shards``
/ ``--gauss_shards`` > 1 (item 7, ``parallel/*``). The SIBR viewer bridge
is not ported either: the run goes on as gsjax's does when its bridge
cannot bind. On its last line the CLI prints one JSON object with the
iterations run, the compositing kernels' launch counts over the run, its
wall time and, on CUDA, the peak device memory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


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
                        help="not ported (ROADMAP Queue 1 item 5)")
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
                        help="not ported beyond 1 (ROADMAP Queue 1 item 7)")
    parser.add_argument("--gauss_shards", type=int, default=1,
                        help="not ported beyond 1 (ROADMAP Queue 1 item 7)")
    parser.add_argument("--multihost", action="store_true",
                        help="not ported (ROADMAP Queue 1 item 7)")
    parser.add_argument("--dist_coordinator", type=str, default=None, metavar="HOST:PORT",
                        help="not ported (ROADMAP Queue 1 item 7)")
    parser.add_argument("--dist_num_processes", type=int, default=None)
    parser.add_argument("--dist_process_id", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda or cpu)")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)
    if args.web_viewer is not None:
        raise NotImplementedError("--web_viewer is not ported: ROADMAP Queue 1 item 5 "
                                  "(the viewer)")
    if args.multihost or any(getattr(args, f"dist_{k}") is not None
                             for k in ("coordinator", "num_processes", "process_id")):
        raise NotImplementedError("--multihost / --dist_* are not ported: ROADMAP Queue 1 "
                                  "item 7 (parallel/*)")

    import torch

    from gsjax_torch.configs import ModelParams, OptimizationParams, PipelineParams, extract
    from gsjax_torch.ops import cuda_composite as cc
    from gsjax_torch.train.loop import training
    from gsjax_torch.utils.system import resolve_device, safe_state

    device = resolve_device(args.device)  # fail before loading anything
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    safe_state(args.quiet, args.seed)  # reference train.py:214

    model = extract(ModelParams, args)
    opt = extract(OptimizationParams, args)
    pipe = extract(PipelineParams, args)
    print(f"Optimizing {model.model_path or '(auto model dir)'}")
    if not args.disable_viewer:
        print("viewer bridge disabled: the SIBR viewer bridge is not ported "
              "(ROADMAP Queue 1 item 5)")

    profile = contextlib.ExitStack()
    passive_callback = None
    if args.profile:
        from gsjax_torch.utils.profiling import trace

        profile.enter_context(trace(args.profile))

        def passive_callback(iteration, state, render_fn):
            if iteration > 100:
                profile.close()  # writes the trace; a no-op once closed

    kernels = (cc.composite_infer, cc.composite_fwd, cc.composite_bwd)
    for k in kernels:
        k.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with profile:
        scene, state = training(
            model, opt, pipe,
            testing_iterations=args.test_iterations,
            saving_iterations=args.save_iterations,
            checkpoint_iterations=args.checkpoint_iterations,
            start_checkpoint=args.start_checkpoint,
            quiet=args.quiet,
            capacity=args.capacity,
            passive_callback=passive_callback,
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
        "stage": "done", "iterations": opt.iterations, "wall_s": wall,
        "num_active": int(state.num_active), "capacity": state.capacity,
        "launches": {k.__name__: k.launches for k in kernels},
        "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                            if device.type == "cuda" else None),
    }
    sys.stdout.flush()
    sys.__stdout__.write(json.dumps(summary) + "\n")  # past --quiet's silenced stdout
    sys.__stdout__.flush()
    return scene, state


if __name__ == "__main__":
    main(sys.argv[1:])
