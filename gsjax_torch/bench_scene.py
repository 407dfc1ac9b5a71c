"""The random scenes and the camera of the benches and the on-card smoke
test — the counterpart of gsjax's ``__graft_entry__._toy_scene``, rebuilt
from the same numpy recipe so that its arrays come out equal to gsjax's."""

from __future__ import annotations

import numpy as np
import torch

from gsjax_torch.data.cameras import Camera
from gsjax_torch.models.gaussians import GaussianState, create_empty


def toy_state(n: int, capacity: int, seed: int = 0, log_scale: float = -2.5,
              device="cuda") -> GaussianState:
    """``n`` random gaussians in [-2, 2]^2 x [4, 10] in front of an identity
    camera, in a state of ``capacity`` slots: log-scales N(``log_scale``,
    0.5) (``-2.5`` gives large blobs, ``-5.2`` the footprints of a trained
    scene, 1-6 tiles at 1080p), DC colors N(0, 0.5), opacity logits N(0,
    1), identity rotations, SH degree 3 with only DC non-zero. Drawn from a
    numpy seed in gsjax's order."""
    rng = np.random.default_rng(seed)
    state = create_empty(capacity, device=device)
    p = state.params

    def put(key, arr):
        p[key][:n] = torch.as_tensor(arr.astype(np.float32), device=state.device)

    put("xyz", np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)],
        axis=1,
    ))
    put("scaling", rng.normal(log_scale, 0.5, (n, 3)))
    put("features_dc", rng.normal(0, 0.5, (n, 1, 3)))
    put("opacity", rng.normal(0, 1, (n, 1)))
    state.active[:n] = True
    state.active_sh_degree = 3
    return state


def bench_camera(width: int, height: int, yaw: float = 0.0, shift=(0.0, 0.0, 0.0)) -> Camera:
    """The bench camera (identity pose, fov_x 0.9), turned by ``yaw``
    radians about the view's y axis and moved by ``shift``."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return Camera(
        uid=0, image_name="bench", R=R, T=np.asarray(shift, np.float64),
        fov_x=0.9, fov_y=0.9 * height / width, width=width, height=height,
    )


def toy_scene(n: int, capacity: int, width: int, height: int, seed: int = 0,
              log_scale: float = -2.5, device="cuda"):
    """``(state, camera)``: :func:`toy_state` and the identity
    :func:`bench_camera` — gsjax's ``_toy_scene``."""
    return (toy_state(n, capacity, seed=seed, log_scale=log_scale, device=device),
            bench_camera(width, height))
