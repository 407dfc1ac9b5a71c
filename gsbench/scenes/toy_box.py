"""gsjax's bench scene (``bench_scene.toy_state`` with log-scale -5.2,
``__graft_entry__._toy_scene``'s recipe), drawn with torch on the device:
``n`` gaussians uniform in [-2, 2]^2 x [4, 10] in front of the bench
camera, log-scales N(-5.2, 0.5), DC colors N(0, 0.5), opacity logits
N(0, 1), identity rotations, SH degree 3 with only the DC band non-zero.

Poses: the bench camera (identity pose, fov_x 0.9, fov_y 0.9 h / w) at the
four poses of the port's smoke test, for training; for the viewer a
fixed loop of poses near them, which a seed enters at its own place and
direction.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from gsbench.reference.cameras import pose

BENCH_POSES = [(0.0, (0.0, 0.0, 0.0)), (0.01, (0.02, 0.0, 0.0)),
               (-0.01, (-0.02, 0.01, 0.0)), (0.0, (0.0, -0.02, 0.0))]


def bench_pose(width, height, yaw=0.0, shift=(0.0, 0.0, 0.0)) -> dict:
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return pose(R, shift, 0.9, width, height, fov_y=0.9 * height / width)


def build(cfg: dict, seed: int, device) -> dict:
    n, cap = cfg["n_gauss"], cfg["capacity"]
    w, h = cfg["width"], cfg["height"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    z = torch.zeros
    params = {
        "xyz": z((cap, 3), device=device), "features_dc": z((cap, 1, 3), device=device),
        "features_rest": z((cap, 15, 3), device=device), "scaling": z((cap, 3), device=device),
        "rotation": z((cap, 4), device=device), "opacity": z((cap, 1), device=device),
    }
    params["rotation"][:, 0] = 1.0
    lo = torch.tensor([-2.0, -2.0, 4.0], device=device)
    hi = torch.tensor([2.0, 2.0, 10.0], device=device)
    params["xyz"][:n] = lo + (hi - lo) * rand(n, 3)
    params["scaling"][:n] = cfg["log_scale"] + 0.5 * randn(n, 3)
    params["features_dc"][:n] = 0.5 * randn(n, 1, 3)
    params["opacity"][:n] = randn(n, 1)
    active = torch.zeros(cap, dtype=torch.bool, device=device)
    active[:n] = True

    loop = cfg["view_loop"]
    k = loop["poses"]
    view = [bench_pose(w, h, loop["yaw"] * math.sin(2 * math.pi * i / k),
                       (loop["shift"] * math.cos(2 * math.pi * i / k),
                        loop["shift"] * math.sin(4 * math.pi * i / k), 0.0))
            for i in range(k)]

    def view_path(s):
        rng = np.random.default_rng(s)
        start, step = int(rng.integers(k)), (1 if rng.integers(2) else -1)
        return ((start + step * i) % k for i in itertools.count())

    return {"params": params, "active": active, "sh_degree": 3,
            "train_poses": [bench_pose(w, h, yaw, sh) for yaw, sh in BENCH_POSES],
            "view_poses": view, "view_path": view_path, "extent": cfg["extent"]}
