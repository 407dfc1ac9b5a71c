"""Scale a trained model to >= N gaussians with its statistics kept:
``python -m gsjax_torch.scale_model``.

Counterpart of gsjax's ``scripts/scale_model.py``, with the same flags and
the same numpy arithmetic, so the same input and seed give the same model
array for array. Every parent is tiled K = ceil(target / n) times; each
clone keeps its parent's scaling (the footprint histogram), rotation and
SH; positions are jittered inside the parent's own ellipsoid (local-frame
noise scaled by exp(scaling) x ``--jitter``, rotated by the parent's
quaternion), the first copy of each parent staying where it was; opacity
is split so that K stacked clones composite to the parent's alpha
(a' = 1 - (1 - a)^(1/K)).

The output is a normal model directory, ``<model>_x<K>/point_cloud/
iteration_<it>/point_cloud.ply`` with ``cfg_args`` and ``cameras.json``
copied and a ``scale_meta.json``, which the render CLI, ``render_bench``,
``viewer_bench`` and the viewer load. It runs on the host only (numpy):

    python -m gsjax_torch.scale_model -m output/synth1296 --target 1100000 \\
        [--iteration -1] [--seed 0] [--jitter 0.35]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import sys

import numpy as np

from gsjax_torch.data.ply import read_ply, write_ply


def quat_rotate(q, v):
    """Rotate vectors v (n, 3) by unit quaternions q (n, 4) [w, x, y, z]."""
    w = q[:, 0:1]
    u = q[:, 1:4]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def build_parser():
    ap = argparse.ArgumentParser(description="scale a trained gsjax_torch model")
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--target", type=int, default=1_100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jitter", type=float, default=0.35,
                    help="positional noise in units of the parent's own per-axis "
                         "stddev (exp(scaling))")
    return ap


def scale_vertices(v: dict, target: int, seed: int, jitter: float):
    """The scaled PLY columns of the ``vertex`` element ``v`` and ``k``."""
    n = len(v["x"])
    k = max(1, -(-target // n))  # ceil
    rng = np.random.default_rng(seed)
    rep = {name: np.tile(col, k) for name, col in v.items()}
    m = n * k

    # positions: local-frame ellipsoid noise rotated into world space
    std = np.exp(np.stack([rep[f"scale_{i}"] for i in range(3)], axis=1))
    q = np.stack([rep[f"rot_{i}"] for i in range(4)], axis=1)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    local = rng.standard_normal((m, 3)).astype(np.float32) * std * jitter
    world = quat_rotate(q.astype(np.float32), local)
    world[:n] = 0.0  # the first copy of each parent keeps its exact position
    for i, name in enumerate("xyz"):
        rep[name] = (rep[name] + world[:, i]).astype(np.float32)

    # opacity: the alpha-correct K-way split in linear space
    alpha = 1.0 / (1.0 + np.exp(-rep["opacity"]))
    alpha = np.clip(1.0 - (1.0 - alpha) ** (1.0 / k), 1e-6, 1 - 1e-6)
    rep["opacity"] = np.log(alpha / (1.0 - alpha)).astype(np.float32)
    return rep, k


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    pattern = os.path.join(args.model_path, "point_cloud", "iteration_*")
    its = sorted(int(re.search(r"iteration_(\d+)", d).group(1)) for d in glob.glob(pattern))
    if not its:
        raise SystemExit(f"no point_cloud/iteration_* in {args.model_path}")
    it = its[-1] if args.iteration == -1 else args.iteration
    src = os.path.join(args.model_path, "point_cloud", f"iteration_{it}", "point_cloud.ply")
    v = read_ply(src)["vertex"]
    rep, k = scale_vertices(v, args.target, args.seed, args.jitter)

    out_dir = args.model_path.rstrip("/") + f"_x{k}"
    pc_dir = os.path.join(out_dir, "point_cloud", f"iteration_{it}")
    os.makedirs(pc_dir, exist_ok=True)
    write_ply(os.path.join(pc_dir, "point_cloud.ply"), rep)
    for aux in ("cfg_args", "cameras.json"):
        p = os.path.join(args.model_path, aux)
        if os.path.exists(p):
            shutil.copy(p, os.path.join(out_dir, aux))
    meta = {"src": src, "n_src": len(v["x"]), "k": k, "n_out": len(rep["x"]),
            "jitter": args.jitter, "seed": args.seed, "opacity_split": "1-(1-a)^(1/K)"}
    with open(os.path.join(out_dir, "scale_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))
    print("wrote", out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
