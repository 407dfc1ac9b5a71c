"""Offline rendering of a trained model — the port's counterpart of the
root ``render.py``, with the same flags and output layout plus
``--device`` (default ``cuda``).

Renders every train/test view to
``<model>/{train,test}/ours_<iteration>/{renders,gt}/NNNNN.png``.

Example:
    python -m gsjax_torch.render -m output/lego
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def render_set(model_path, name, iteration, cameras, render_fn, state, bg):
    """reference render.py:24-35."""
    from PIL import Image

    base = os.path.join(model_path, name, f"ours_{iteration}")
    render_dir = os.path.join(base, "renders")
    gt_dir = os.path.join(base, "gt")
    os.makedirs(render_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    total_dropped = 0
    for idx, cam in enumerate(cameras):
        img, dropped = render_fn(state, cam.to_render_camera(state.device), bg)
        img = img.clamp(0.0, 1.0).cpu().numpy()
        dropped = int(dropped)
        if dropped > 0:
            print(
                f"WARNING: view {idx}: {dropped} pairs dropped (budget "
                "overflow) — render may be darkened; re-probe or raise "
                "max_pairs/max_tiles_per_gauss"
            )
        total_dropped += dropped
        gt = np.clip(np.asarray(cam.image), 0.0, 1.0)
        if cam.alpha_mask is not None:
            gt = gt * np.asarray(cam.alpha_mask)[..., None]
        Image.fromarray((img * 255 + 0.5).astype(np.uint8)).save(
            os.path.join(render_dir, f"{idx:05d}.png")
        )
        Image.fromarray((gt * 255 + 0.5).astype(np.uint8)).save(
            os.path.join(gt_dir, f"{idx:05d}.png")
        )
    return total_dropped


def render_sets(model, iteration, skip_train, skip_test, device="cuda"):
    """reference render.py:37-49."""
    import torch

    from gsjax_torch.train.loop import probe_rasterize_settings
    from gsjax_torch.train.scene import Scene
    from gsjax_torch.train.step import TrainConfig, make_render_fn

    scene = Scene(model, load_iteration=iteration, shuffle=False, device=device)
    state = scene.gaussians
    cams = scene.get_train_cameras() or scene.get_test_cameras()
    settings = None
    if cams:
        # budget-probe against the loaded model: trained scenes keep
        # gaussians spanning hundreds of tiles, which the default tile cap
        # would silently drop (reference renders never drop)
        settings = probe_rasterize_settings(
            state, cams, cams[0].width, cams[0].height
        )
    render_fn = make_render_fn(TrainConfig(settings=settings), with_stats=True)
    bg = torch.full((3,), 1.0 if model.white_background else 0.0,
                    dtype=torch.float32, device=state.device)

    total_dropped = 0
    if not skip_train:
        total_dropped += render_set(
            model.model_path, "train", scene.loaded_iter,
            scene.get_train_cameras(), render_fn, state, bg,
        )
    if not skip_test:
        total_dropped += render_set(
            model.model_path, "test", scene.loaded_iter,
            scene.get_test_cameras(), render_fn, state, bg,
        )
    if total_dropped > 0:
        print(
            f"WARNING: {total_dropped} pairs dropped across all views — "
            "some renders are not faithful to the model"
        )
    return total_dropped


def main(argv=None):
    from gsjax_torch.configs import (
        ModelParams, PipelineParams, add_group, extract, get_combined_args,
    )

    parser = argparse.ArgumentParser(description="gsjax_torch offline rendering")
    add_group(parser, ModelParams, "Model Parameters")
    add_group(parser, PipelineParams, "Pipeline Parameters")
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (cuda or cpu)")
    args = get_combined_args(parser, argv)

    from gsjax_torch.utils.system import resolve_device, safe_state

    device = resolve_device(args.device)  # fail before loading anything
    safe_state(args.quiet)  # reference render.py:61

    model = extract(ModelParams, args)
    print(f"Rendering {model.model_path}")
    return render_sets(model, args.iteration, args.skip_train, args.skip_test,
                       device=device)


if __name__ == "__main__":
    main()
