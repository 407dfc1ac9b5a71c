"""Pinhole cameras as the 3DGS reference builds them (column-vector
convention; view z maps to clip w).

A pose is a dict ``{"R": (3, 3) camera-to-world rotation, "T": (3,)
world-to-camera translation, "fov_x", "fov_y", "width", "height"}`` in
float64 numpy, the storage of the COLMAP readers (reference 3DGS
scene/dataset_readers.py:82-84). :func:`camera_tensors` gives the float32
tensors a render needs; the benchmark hands the same tensors to the
program, as its ``RenderCamera`` fields.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ZNEAR, ZFAR = 0.01, 100.0  # reference scene/cameras.py:48-49
TENSORS = ("world_view", "full_proj", "camera_center", "tan_fov_x", "tan_fov_y")


def world_to_view(R, t) -> np.ndarray:
    """(4, 4) float32 world-to-view matrix (reference
    utils/graphics_utils.py:38-49 with no recentring)."""
    w2c = np.zeros((4, 4), dtype=np.float64)
    w2c[:3, :3] = np.asarray(R).T
    w2c[:3, 3] = np.asarray(t)
    w2c[3, 3] = 1.0
    c2w = np.linalg.inv(w2c)
    return np.linalg.inv(c2w).astype(np.float32)


def projection_matrix(fov_x, fov_y) -> np.ndarray:
    """(4, 4) perspective with z in [0, 1] and w = view z (reference
    utils/graphics_utils.py:51-71)."""
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / math.tan(fov_x / 2)
    P[1, 1] = 1.0 / math.tan(fov_y / 2)
    P[2, 2] = ZFAR / (ZFAR - ZNEAR)
    P[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    P[3, 2] = 1.0
    return P


def pose(R, T, fov_x, width, height, fov_y=None) -> dict:
    if fov_y is None:
        fov_y = 2 * math.atan(math.tan(fov_x / 2) * height / width)
    return {"R": np.asarray(R, np.float64), "T": np.asarray(T, np.float64),
            "fov_x": float(fov_x), "fov_y": float(fov_y), "width": int(width),
            "height": int(height)}


def lookat_pose(eye, target, fov_x, width, height, up=(0.0, 0.0, 1.0)) -> dict:
    """A camera at ``eye`` looking at ``target``, built in OpenGL axes (y
    up, z back) and turned to COLMAP's (y down, z forward)."""
    eye = np.asarray(eye, np.float64)
    z = eye - np.asarray(target, np.float64)
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP
    w2c = np.linalg.inv(c2w)
    return pose(w2c[:3, :3].T, w2c[:3, 3], fov_x, width, height)


def camera_tensors(p: dict, device) -> dict:
    """The float32 tensors of pose ``p`` on ``device``, with ``width`` and
    ``height``."""
    wv = world_to_view(p["R"], p["T"])
    full = (projection_matrix(p["fov_x"], p["fov_y"]) @ wv).astype(np.float32)
    center = np.linalg.inv(wv)[:3, 3].astype(np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return {"world_view": t(wv), "full_proj": t(full), "camera_center": t(center),
            "tan_fov_x": t(np.tan(p["fov_x"] / 2)), "tan_fov_y": t(np.tan(p["fov_y"] / 2)),
            "width": p["width"], "height": p["height"]}
