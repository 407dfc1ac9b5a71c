"""Camera matrix construction (numpy; a copy of ``gsjax.utils.camera``).

The port uses the *standard column-vector convention* internally:
``p_view = W2C @ [p; 1]`` with W2C a (4, 4) world-to-view matrix. The
reference stores these matrices transposed (row-vector / glm convention,
reference: scene/cameras.py:54-56) — the port transposes only at interchange
boundaries (cameras.json, the viewer wire protocol), never internally.

Projection follows the reference's OpenGL-style matrix with z mapped to
[0, 1] and ``P[3, 2] = 1`` (reference: utils/graphics_utils.py:51-71),
so clip-space w equals view-space z.
"""

from __future__ import annotations

import math

import numpy as np


def world_to_view(R, t, translate=np.zeros(3), scale=1.0):
    """(4,4) world-to-view matrix from COLMAP-style extrinsics.

    ``R`` is the camera-to-world rotation (3,3) — COLMAP's ``qvec2rotmat(q).T``
    as stored by the readers (reference: scene/dataset_readers.py:82) — and
    ``t`` the world-to-camera translation. ``translate``/``scale`` recentre
    and rescale camera positions (reference: utils/graphics_utils.py:38-49).
    """
    w2c = np.zeros((4, 4), dtype=np.float64)
    w2c[:3, :3] = np.asarray(R).T
    w2c[:3, 3] = np.asarray(t)
    w2c[3, 3] = 1.0
    c2w = np.linalg.inv(w2c)
    c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
    return np.linalg.inv(c2w).astype(np.float32)


def projection_matrix(znear, zfar, fov_x, fov_y):
    """(4,4) perspective projection, z in [0,1], w = view z.

    Matches reference getProjectionMatrix (utils/graphics_utils.py:51-71).
    """
    tan_x = math.tan(fov_x / 2)
    tan_y = math.tan(fov_y / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def focal_to_fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))


def fov_to_focal(fov, pixels):
    return pixels / (2 * math.tan(fov / 2))
