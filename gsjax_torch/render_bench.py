"""Trained-scene rendering throughput — the port's counterpart of
``scripts/render_bench.py``, the analogue of the reference's headline claim
("≥30 fps at 1080p on a modern GPU" for *rendering trained scenes*,
reference README.md:14).

Loads a trained model directory (the layout the render CLI consumes),
renders its test cameras through the inference path (``make_render_fn``,
the ``composite_infer`` kernel on CUDA) and reports frames/s — at the
scene's native resolution or, with ``--at_1080p``, at 1920x1080. The same
flags as gsjax's script plus ``--device`` (default ``cuda``).

Frames are timed with CUDA events, the fewest ms per frame of 3 passes
over the views; each frame's input is perturbed (gsjax's ``eps``) and its
drop counter read. A run in which any timed view dropped a pair prints no
frames/s and exits 1: the number would not be of a drop-free
configuration.

Usage:
    python -m gsjax_torch.render_bench -m output/synth_garden \\
        [--iteration 30000] [--at_1080p] [--views 8]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPS = 3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--tier_frac", type=float, default=None,
                    help="override the probed tiered-binning fraction")
    ap.add_argument("--expansion", choices=("grid", "compact"), default=None,
                    help="override the probed pair-expansion strategy")
    ap.add_argument("--views", type=int, default=8,
                    help="number of test views to cycle through")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report atomically to this "
                         "path on success (crash-safe, stdout-noise-free)")
    ap.add_argument("--at_1080p", action="store_true",
                    help="rescale camera intrinsics to 1920x1080")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda or cpu)")
    args = ap.parse_args(argv)

    import torch

    from gsjax_torch.configs import ModelParams, load_cfg_args
    from gsjax_torch.train.loop import probe_rasterize_settings
    from gsjax_torch.train.scene import Scene
    from gsjax_torch.train.step import TrainConfig, make_render_fn
    from gsjax_torch.utils.system import resolve_device

    device = resolve_device(args.device)  # fail before reading anything
    model = ModelParams(source_path="", model_path=args.model_path, eval=True)
    # cfg_args in the model dir restores the real source_path
    saved = load_cfg_args(args.model_path)
    model = dataclasses.replace(
        model,
        source_path=saved.get("source_path", model.source_path),
        white_background=saved.get("white_background", model.white_background),
        sh_degree=saved.get("sh_degree", model.sh_degree),
    )
    scene = Scene(model, load_iteration=args.iteration, shuffle=False, device=device)
    state = scene.gaussians
    cams = scene.get_test_cameras() or scene.get_train_cameras()
    cams = cams[: args.views]

    w, h = cams[0].width, cams[0].height
    if args.at_1080p:
        # keep fov_x, recompute fov_y for the 16:9 aspect — same horizontal
        # view rendered through real 1080p intrinsics (anisotropic pixels
        # would distort the splat-per-pixel workload and the fps claim)
        for i, c in enumerate(cams):
            fov_y = 2 * np.arctan(np.tan(c.fov_x / 2) * 1080 / 1920)
            cams[i] = dataclasses.replace(c, width=1920, height=1080, fov_y=float(fov_y))
        w, h = 1920, 1080

    # budget-probe against the loaded model: static defaults silently drop
    # the widest trained gaussians' tiles, inflating fps while darkening
    # renders — the fps claim must come from a drop-free configuration
    settings = probe_rasterize_settings(state, cams, w, h)
    settings = dataclasses.replace(settings, backend="kernel")
    if args.tier_frac is not None:
        settings = dataclasses.replace(settings, tier_frac=args.tier_frac)
    if args.expansion is not None:
        settings = dataclasses.replace(settings, expansion=args.expansion)
    render_fn = make_render_fn(TrainConfig(settings=settings), with_stats=True)
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, dtype=torch.float32,
                    device=device)
    rcams = [c.to_render_camera(device) for c in cams]
    n_views = len(cams)

    def frame(view_i, eps):
        p = dict(state.params)
        p["xyz"] = p["xyz"] + eps
        img, dropped = render_fn(dataclasses.replace(state, params=p), rcams[view_i], bg)
        # checksum + drop counter: the timed loop verifies the drop-free
        # claim on EVERY rendered view, not from the probe's 4-view sample
        return torch.stack([img[::64, ::64].sum(), dropped.to(torch.float32)])

    cuda = device.type == "cuda"
    frame(0, 0.0)  # warm-up
    samples, outs = [], []
    for rep in range(REPS):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        for i in range(n_views):
            outs.append(frame(i, (rep * n_views + i + 1) * 1e-12))
        if cuda:
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3 / n_views)
        else:  # the CPU's work is done when its ops return
            samples.append((time.perf_counter() - t0) / n_views)
    outs = torch.stack(outs).cpu().numpy()
    if not np.isfinite(outs[:, 0]).all():
        print("ERROR: a timed view rendered non-finite values", file=sys.stderr)
        return 1
    total_dropped = int(outs[:, 1].sum())
    if total_dropped > 0:
        print(f"ERROR: {total_dropped} pairs dropped across the timed views — no "
              "frames/s from a configuration that drops pairs; raise the budgets "
              "(max_pairs / max_tiles_per_gauss)", file=sys.stderr)
        return 1
    t_frame = max(min(samples), 1e-9)
    if cuda:
        from gsjax_torch.utils.profiling import card

        dev_name = card()  # the card's name and power limit
    else:
        dev_name = str(device)
    report = {
        "metric": "trained-scene render frames/s",
        "value": round(1.0 / t_frame, 3),
        "unit": "frames/s",
        "vs_baseline": round(1.0 / t_frame / 30.0, 4),
        "extra": {
            "resolution": f"{w}x{h}",
            "n_gaussians": int(state.num_active),
            "n_views": n_views,
            "iteration": scene.loaded_iter,
            "tier_frac": settings.tier_frac,
            "expansion": settings.expansion,
            "max_tiles_per_gauss": settings.max_tiles_per_gauss,
            "max_pairs": settings.max_pairs,
            "rtt_ms": 0.0,  # events time the device: no host round trip to subtract
            "device": dev_name,
            "num_dropped": total_dropped,
        },
    }
    print(json.dumps(report))
    if args.out:
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f)
        with open(tmp) as f:
            json.load(f)  # parse-before-commit guard
        os.replace(tmp, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
