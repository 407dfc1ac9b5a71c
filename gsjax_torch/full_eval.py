"""Full benchmark-suite orchestrator — the port's counterpart of the root
``full_eval.py`` (reference: full_eval.py:15-75), with the same flags plus
``--device`` (default ``cuda``).

Trains the 13 benchmark scenes (MipNeRF360 at the paper's resolutions,
Tanks&Temples, Deep Blending), renders the 7k/30k snapshots and computes
metrics, by running the port's CLIs (``python -m gsjax_torch.train``,
``gsjax_torch.render``, ``gsjax_torch.metrics``) as subprocesses.

Example:
    python -m gsjax_torch.full_eval -m360 /data/360_v2 --output_path ./eval
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump", "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(cmd):
    """Run one shell command with this checkout's package importable."""
    print("+", cmd, flush=True)
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    subprocess.run(cmd, shell=True, check=True, env={**os.environ, "PYTHONPATH": path})


def main(argv=None):
    parser = argparse.ArgumentParser(description="Full evaluation script")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", default=None, type=str)
    parser.add_argument("--tanksandtemples", "-tat", default=None, type=str)
    parser.add_argument("--deepblending", "-db", default=None, type=str)
    parser.add_argument(
        "--scenes", nargs="+", default=None, type=str, metavar="DIR",
        help="extra scene directories to evaluate verbatim (e.g. the "
             "synthetic scene of python -m gsjax_torch.synthetic_scene)",
    )
    parser.add_argument(
        "--iterations", default=None, type=int,
        help="override the 30k training schedule (snapshots scale with it)",
    )
    parser.add_argument("--extra_train_args", default="", type=str)
    parser.add_argument("--device", default="cuda",
                        help="torch device every stage runs on (cuda or cpu)")
    args = parser.parse_args(argv)

    from gsjax_torch.utils.system import resolve_device

    resolve_device(args.device)  # fail before running anything
    py = sys.executable
    train_py = "-m gsjax_torch.train"
    render_py = "-m gsjax_torch.render"
    metrics_py = "-m gsjax_torch.metrics"
    dev = f"--device {args.device}"

    scenes = []
    if args.mipnerf360:
        scenes += [(os.path.join(args.mipnerf360, s), "-i images_4")
                   for s in mipnerf360_outdoor_scenes]
        scenes += [(os.path.join(args.mipnerf360, s), "-i images_2")
                   for s in mipnerf360_indoor_scenes]
    if args.tanksandtemples:
        scenes += [(os.path.join(args.tanksandtemples, s), "") for s in tanks_and_temples_scenes]
    if args.deepblending:
        scenes += [(os.path.join(args.deepblending, s), "") for s in deep_blending_scenes]
    if args.scenes:
        scenes += [(s.rstrip("/"), "") for s in args.scenes]
    if not scenes:
        parser.error("pass at least one of --mipnerf360/--tanksandtemples/--deepblending/--scenes")

    snapshots = (7000, 30000)
    iter_flag = ""
    if args.iterations is not None:
        snapshots = tuple(sorted({min(7000, args.iterations), args.iterations}))
        save = " ".join(str(s) for s in snapshots)
        iter_flag = f"--iterations {args.iterations} --save_iterations {save}"

    common = f"--quiet --eval --test_iterations -1 {iter_flag}".strip()
    if not args.skip_training:
        for source, extra in scenes:
            name = os.path.basename(source)
            run(f"{py} {train_py} -s {source} {extra} {common} "
                f"{args.extra_train_args} -m {args.output_path}/{name} {dev}")

    if not args.skip_rendering:
        for source, _ in scenes:
            name = os.path.basename(source)
            for it in snapshots:
                run(f"{py} {render_py} --iteration {it} -s {source} "
                    f"-m {args.output_path}/{name} --skip_train {dev}")

    if not args.skip_metrics:
        all_models = " ".join(f"{args.output_path}/{os.path.basename(s)}" for s, _ in scenes)
        run(f"{py} {metrics_py} -m {all_models} {dev}")


if __name__ == "__main__":
    main()
