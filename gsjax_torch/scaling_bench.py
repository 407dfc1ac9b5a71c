"""Sharded train-step throughput at increasing ``gauss`` sizes.

Counterpart of gsjax's ``scripts/scaling_bench.py``: for each ``gauss``
size G, G ranks (one process each, started by
``parallel.multihost.spawn_ranks``) train the random bench scene
(``bench_scene.toy_state``, 1M gaussians at 1920x1080 by default, log
scale -5.2) through ``make_sharded_train_step``, and rank 0 times
``--steps`` steps after one warm-up. One JSON report line: steps/s per G,
the backend of each, the scaling efficiency against G = 1 where it means
something, and a note where it does not.

    python -m gsjax_torch.scaling_bench --gauss 1 2 4      # one card per rank
    python -m gsjax_torch.scaling_bench --device cpu        # the mechanics

Ranks that share one card (more ranks than cards: gloo, each rank's
kernels queued on the same device) or run on the CPU give no scaling
efficiency: the report says so and leaves it out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 900  # one gauss size's ranks, start-up and steps


def build_parser():
    ap = argparse.ArgumentParser(description="gsjax_torch sharded-step scaling")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--gauss", type=int, nargs="+", default=[1, 2],
                    help="gauss mesh sizes to measure (one rank each)")
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--capacity", type=int, default=1 << 20)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--exchange", default="all_gather", choices=("all_gather", "a2a"),
                    help="splat exchange (a2a: only to the strips a splat overlaps)")
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    return ap


def rank_main(args) -> dict:
    """One rank: build, warm up, time ``args.steps`` sharded steps."""
    import numpy as np
    import torch

    from gsjax_torch.bench_scene import toy_scene
    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.data.cameras import stack_render_cameras
    from gsjax_torch.parallel import make_mesh, make_sharded_train_step, shard_gaussian_state
    from gsjax_torch.parallel.multihost import maybe_initialize
    from gsjax_torch.train.loop import probe_rasterize_settings
    from gsjax_torch.train.optim import make_optimizer
    from gsjax_torch.train.step import TrainConfig

    maybe_initialize(device=args.device)
    mesh = make_mesh(data=1, device=args.device)
    dev = mesh.device
    state, cam = toy_scene(args.gaussians, args.capacity, args.width, args.height,
                           log_scale=-5.2, device=dev)
    settings = probe_rasterize_settings(state, [cam], args.width, args.height)
    settings = dataclasses.replace(settings, splat_exchange=args.exchange)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (1, args.height, args.width, 3)).astype(np.float32)
    tx = make_optimizer(OptimizationParams(), 3.0)
    local = shard_gaussian_state(state, mesh)
    del state
    opt = tx.init(local.params)
    step = make_sharded_train_step(tx, mesh, stack_render_cameras([cam], dev), images,
                                   TrainConfig(settings=settings, extent=3.0))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    local, opt, m = step(local, opt, [0])  # warm-up
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda *a: None)
    sync(dev)
    dropped = int(m["num_dropped_pairs"])
    t0 = time.perf_counter()
    for _ in range(args.steps):
        local, opt, m = step(local, opt, [0])
        dropped = max(dropped, int(m["num_dropped_pairs"]))
    sync(dev)
    dt = (time.perf_counter() - t0) / args.steps
    return {"gauss": mesh.gauss, "backend": mesh.backend, "steps_per_s": 1.0 / dt,
            "step_ms": 1e3 * dt, "loss": float(m["loss"]), "num_dropped_pairs": dropped,
            "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                                if dev.type == "cuda" else None)}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.rank:
        out = rank_main(args)
        if int(os.environ.get("GSJAX_PROCESS_ID", "0")) == 0:
            print(json.dumps(out), flush=True)
        return 0

    import torch

    from gsjax_torch.parallel.multihost import spawn_ranks
    from gsjax_torch.utils.system import resolve_device

    dev = resolve_device(args.device)  # fail before launching anything
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    forward = list(argv if argv is not None else sys.argv[1:])
    results = {}
    for g in args.gauss:
        res = spawn_ranks([sys.executable, "-m", "gsjax_torch.scaling_bench", *forward,
                           "--rank"], g, RANK_TIMEOUT_S, cwd=HERE,
                          threads=1 if dev.type == "cpu" else None)
        results[g] = json.loads(res[0].stdout.strip().splitlines()[-1])
        print(f"gauss {g}: {results[g]['steps_per_s']:.3f} steps/s over "
              f"{results[g]['backend']}", file=sys.stderr, flush=True)
    shared = [g for g in results if g > cards]
    report = {
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "cards": cards,
        "exchange": args.exchange,
        "gaussians": args.gaussians, "width": args.width, "height": args.height,
        "steps_per_s": {str(g): r["steps_per_s"] for g, r in results.items()},
        "step_ms": {str(g): r["step_ms"] for g, r in results.items()},
        "backend": {str(g): r["backend"] for g, r in results.items()},
        "num_dropped_pairs": {str(g): r["num_dropped_pairs"] for g, r in results.items()},
        "peak_memory_gib": {str(g): r["peak_memory_gib"] for g, r in results.items()},
    }
    if 1 in results and 1 not in shared:
        base = results[1]["steps_per_s"]
        report["efficiency"] = {str(g): r["steps_per_s"] / (base * g)
                                for g, r in results.items() if g not in shared}
    if shared:
        report["note"] = (f"gauss {shared}: more ranks than cards ({cards}); the ranks share "
                          "a card (or the CPU) over gloo, so no scaling efficiency is "
                          "meaningful there")
    if dev.type == "cuda":
        from gsjax_torch.utils.profiling import card

        report["card"] = card()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
