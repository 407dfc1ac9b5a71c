"""A/B of the densify-iteration gradient: ``python -m
gsjax_torch.densify_grad_ab``.

Counterpart of gsjax's ``scripts/densify_grad_ab.py``. The reference
discards the gradient step of a densification iteration (its optimizer
surgery leaves ``.grad=None``, reference train.py:118-128); gsjax and the
port apply it by default. This trains the same synthetic scene twice
through ``train.loop.training`` — ``densify_iter_grad="apply"`` and
``"discard"``, seed 0 — and scores each final state on the test split and
the first five training views (``train.loop.evaluate_state``).

The scene is made by ``python -m gsjax_torch.synthetic_scene`` at the
script's defaults (512x512, 60 views, 120,000 gaussians, 15,000 sparse
points) unless ``--scene`` already holds one. The report has gsjax's keys;
``device`` is the card's name and power limit (``nvidia-smi``), or ``cpu``.
It goes to ``--out`` (default ``output/quality/densify_grad_ab.json``), the
models under ``--model_root`` (default ``output``). ``--densify_from_iter``,
``--densification_interval``, ``--densify_until_iter`` and
``--opacity_reset_interval`` cut the densification schedule for a short
run (default: the reference's).

    python -m gsjax_torch.densify_grad_ab [--iterations 7000] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ensure_scene(path, width, height, n_views, n_gauss, n_sparse, device):
    if os.path.isdir(os.path.join(path, "sparse", "0")):
        return
    print(f"generating synthetic scene at {path}", flush=True)
    subprocess.run([sys.executable, "-m", "gsjax_torch.synthetic_scene", path,
                    "--n_views", str(n_views), "--width", str(width), "--height", str(height),
                    "--n_gauss", str(n_gauss), "--n_sparse", str(n_sparse),
                    "--device", device], check=True, cwd=REPO)


def _git_head() -> str:
    """The checkout's short commit ("" outside a git checkout)."""
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                              text=True, cwd=REPO).stdout.strip()
    except OSError:
        return ""


def build_parser():
    ap = argparse.ArgumentParser(description="gsjax_torch densify-iteration gradient A/B")
    ap.add_argument("--scene", default="data/synth_ab")
    ap.add_argument("--iterations", type=int, default=7000)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--n_views", type=int, default=60)
    ap.add_argument("--n_gauss", type=int, default=120_000)
    ap.add_argument("--n_sparse", type=int, default=15_000)
    ap.add_argument("--out", default=os.path.join("output", "quality", "densify_grad_ab.json"))
    ap.add_argument("--model_root", default="output")
    ap.add_argument("--densify_from_iter", type=int, default=None)
    ap.add_argument("--densification_interval", type=int, default=None)
    ap.add_argument("--densify_until_iter", type=int, default=None)
    ap.add_argument("--opacity_reset_interval", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import dataclasses

    import torch

    from gsjax_torch.configs import ModelParams, OptimizationParams, PipelineParams
    from gsjax_torch.train.loop import default_rasterize_settings, evaluate_state, training
    from gsjax_torch.train.step import TrainConfig, make_render_fn
    from gsjax_torch.utils.system import resolve_device

    dev = resolve_device(args.device)  # fail before making anything
    scene_dir = os.path.abspath(args.scene)
    ensure_scene(scene_dir, args.width, args.height, args.n_views, args.n_gauss,
                 args.n_sparse, args.device)
    schedule = {k: getattr(args, k) for k in ("densify_from_iter", "densification_interval",
                                              "densify_until_iter", "opacity_reset_interval")
                if getattr(args, k) is not None}

    results = {}
    for mode in ("apply", "discard"):
        model = ModelParams(source_path=scene_dir, eval=True,
                            model_path=os.path.join(args.model_root, f"densify_ab_{mode}"))
        opt = dataclasses.replace(OptimizationParams(), iterations=args.iterations,
                                  position_lr_max_steps=args.iterations, **schedule)
        t0 = time.time()
        scene, state = training(model, opt, PipelineParams(),
                                testing_iterations=(args.iterations,), saving_iterations=(),
                                quiet=True, seed=0, densify_iter_grad=mode, device=dev)
        wall = time.time() - t0
        # the final eval through the report path (the renderer the
        # in-training hook uses)
        cam0 = scene.get_train_cameras()[0]
        cfg = TrainConfig(settings=default_rasterize_settings(cam0.width, cam0.height,
                                                              state.capacity),
                          extent=float(scene.cameras_extent))
        report = evaluate_state(state, scene, make_render_fn(cfg),
                                torch.zeros(3, device=state.device))
        results[mode] = {"report": report, "final_gaussians": int(state.num_active),
                         "wall_s": round(wall, 1)}
        print(f"{mode}: {json.dumps(report)} ({wall:.0f}s)", flush=True)

    if dev.type == "cuda":
        from gsjax_torch.utils.profiling import card

        device = card()
    else:
        device = "cpu"
    out = {
        "experiment": "densify-iteration gradient apply vs discard",
        "reference_semantics": "discard (reference train.py:118-128)",
        "iterations": args.iterations,
        "scene": args.scene,
        "results": results,
        "device": device,
        "git": _git_head(),
        "cmd": " ".join(sys.argv),
        "t": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
