"""Camera containers.

:class:`Camera` is the host-side record (pose + intrinsics + GT image as
numpy), as in ``gsjax.data.cameras``. :class:`RenderCamera` is the
device-facing view: small float32 tensors (matrices, scalars) on one
device plus ``int`` width and height. Matrices use the column-vector
convention (see :mod:`gsjax_torch.utils.camera`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gsjax_torch.utils.camera import projection_matrix, world_to_view
from gsjax_torch.utils.system import resolve_device

ZNEAR = 0.01  # reference: scene/cameras.py:48
ZFAR = 100.0  # reference: scene/cameras.py:49


@dataclasses.dataclass
class Camera:
    """Host-side camera: COLMAP-style extrinsics + pinhole intrinsics + image.

    ``R`` is camera-to-world rotation, ``T`` world-to-camera translation
    (the storage convention of the COLMAP readers,
    reference: scene/dataset_readers.py:82-84).
    """

    uid: int
    image_name: str
    R: np.ndarray  # (3, 3)
    T: np.ndarray  # (3,)
    fov_x: float
    fov_y: float
    width: int
    height: int
    image: Optional[np.ndarray] = None  # (H, W, 3) float32 in [0, 1]
    alpha_mask: Optional[np.ndarray] = None  # (H, W) float32
    znear: float = ZNEAR
    zfar: float = ZFAR
    trans: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    @property
    def world_view(self) -> np.ndarray:
        return world_to_view(self.R, self.T, self.trans, self.scale)

    @property
    def projection(self) -> np.ndarray:
        return projection_matrix(self.znear, self.zfar, self.fov_x, self.fov_y)

    @property
    def full_proj(self) -> np.ndarray:
        # column-vector convention: project(view(p)) = (P @ W) @ p
        return (self.projection @ self.world_view).astype(np.float32)

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.world_view)[:3, 3].astype(np.float32)

    def to_render_camera(self, device="cuda") -> "RenderCamera":
        dev = resolve_device(device)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return RenderCamera(
            world_view=t(self.world_view),
            full_proj=t(self.full_proj),
            camera_center=t(self.camera_center),
            tan_fov_x=t(np.tan(self.fov_x / 2)),
            tan_fov_y=t(np.tan(self.fov_y / 2)),
            width=int(self.width),
            height=int(self.height),
        )


@dataclasses.dataclass(frozen=True)
class RenderCamera:
    """Device-facing camera: float32 tensors on one device."""

    world_view: torch.Tensor  # (4, 4)
    full_proj: torch.Tensor  # (4, 4)
    camera_center: torch.Tensor  # (3,)
    tan_fov_x: torch.Tensor  # ()
    tan_fov_y: torch.Tensor  # ()
    width: int
    height: int

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tan_fov_x)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tan_fov_y)


def stack_render_cameras(cams, device="cuda"):
    """Same-resolution cameras as one camera batch for the train step — a
    list of :class:`RenderCamera` on ``device`` (gsjax stacks them into
    one batched pytree for in-jit indexing; the port indexes a list)."""
    rcs = [c.to_render_camera(device) if isinstance(c, Camera) else c for c in cams]
    w, h = rcs[0].width, rcs[0].height
    if any(rc.width != w or rc.height != h for rc in rcs):
        raise ValueError("stack_render_cameras requires uniform resolution")
    return rcs


def index_render_camera(batch, i) -> RenderCamera:
    """Select camera ``i`` (an int or a 0-d integer tensor) from a batch of
    :func:`stack_render_cameras`."""
    return batch[int(i)]


def lookat_camera(eye, target, up, fov_x, width, height,
                  uid=0, name="lookat") -> Camera:
    """Free camera from eye/target/up (world coordinates, any up axis).

    Built in the OpenGL convention (y up, z back) then converted to the
    COLMAP storage the rest of the stack uses — the same path as the
    dataset fixtures, so a lookat camera placed at a training camera's
    position reproduces its view."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    n = np.linalg.norm(fwd)
    fwd = fwd / (n if n > 1e-12 else 1.0)
    z = -fwd  # OpenGL camera looks along -z
    up = np.asarray(up, np.float64)
    x = np.cross(up, z)
    n = np.linalg.norm(x)
    if n < 1e-9:  # up parallel to view axis: pick any perpendicular
        alt = np.array([1.0, 0.0, 0.0])
        if abs(z[0]) > 0.9:
            alt = np.array([0.0, 1.0, 0.0])
        x = np.cross(alt, z)
        n = np.linalg.norm(x)
    x /= n
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axis flip
    w2c = np.linalg.inv(c2w)
    fov_y = 2 * np.arctan(np.tan(fov_x / 2) * height / width)
    return Camera(
        uid=uid, image_name=name, R=w2c[:3, :3].T, T=w2c[:3, 3],
        fov_x=float(fov_x), fov_y=float(fov_y),
        width=int(width), height=int(height),
    )
