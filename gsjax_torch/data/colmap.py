"""COLMAP sparse-reconstruction parsers (binary and text).

Implements the documented COLMAP output format
(https://colmap.github.io/format.html) for ``cameras``, ``images`` and
``points3D`` files; functional parity with the reference's struct-level
readers (reference: scene/colmap_loader.py:83-270) but vectorized with numpy
``frombuffer`` record parsing where the layout allows. A numpy copy of
``gsjax.data.colmap``.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict

import numpy as np

# model_id -> (name, num_params). COLMAP's full camera-model table
# (reference: scene/colmap_loader.py:24-36).
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass(frozen=True)
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass(frozen=True)
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) w,x,y,z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec_to_rotmat(qvec):
    """COLMAP (w,x,y,z) quaternion -> rotation matrix (world-to-camera).

    Same formula as reference scene/colmap_loader.py:43-55.
    """
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat_to_qvec(R):
    """Rotation matrix -> (w,x,y,z) quaternion, w >= 0.

    Eigenvector-of-K method (reference: scene/colmap_loader.py:57-66).
    """
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec = -qvec
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, 24, "iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * num_params, "d" * num_params))
            cams[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cams


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            vals = _read(f, 64, "idddddddi")
            image_id, camera_id = vals[0], vals[8]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (num_pts,) = _read(f, 8, "Q")
            f.seek(24 * num_pts, os.SEEK_CUR)  # skip 2D points (xy + p3d id)
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8")
            )
    return images


def read_points3d_binary(path):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, error (N,) f64)."""
    xyzs, rgbs, errs = [], [], []
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            vals = _read(f, 43, "QdddBBBd")
            xyzs.append(vals[1:4])
            rgbs.append(vals[4:7])
            errs.append(vals[7])
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return (
        np.asarray(xyzs, dtype=np.float64).reshape(-1, 3),
        np.asarray(rgbs, dtype=np.uint8).reshape(-1, 3),
        np.asarray(errs, dtype=np.float64).reshape(-1),
    )


def _data_lines(path):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cams = {}
    for line in _data_lines(path):
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        width, height = int(parts[2]), int(parts[3])
        params = np.array([float(p) for p in parts[4:]])
        cams[cam_id] = ColmapCamera(cam_id, model, width, height, params)
    return cams


def read_images_text(path) -> Dict[int, ColmapImage]:
    """Every record is a header line + a POINTS2D line; the second line is
    *empty* for images with no observations, so records cannot be paired
    after blank-line stripping — iterate raw lines instead."""
    images = {}
    expect_points = False
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line.startswith("#"):
                continue
            if expect_points:  # skip the POINTS2D line (possibly empty)
                expect_points = False
                continue
            if not line:
                continue
            parts = line.split()
            image_id = int(parts[0])
            qvec = np.array([float(p) for p in parts[1:5]])
            tvec = np.array([float(p) for p in parts[5:8]])
            camera_id = int(parts[8])
            name = " ".join(parts[9:])
            images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name)
            expect_points = True
    return images


def read_points3d_text(path):
    xyzs, rgbs, errs = [], [], []
    for line in _data_lines(path):
        parts = line.split()
        xyzs.append([float(p) for p in parts[1:4]])
        rgbs.append([int(p) for p in parts[4:7]])
        errs.append(float(parts[7]))
    return (
        np.asarray(xyzs, dtype=np.float64).reshape(-1, 3),
        np.asarray(rgbs, dtype=np.uint8).reshape(-1, 3),
        np.asarray(errs, dtype=np.float64).reshape(-1),
    )


def write_cameras_binary(cams: Dict[int, ColmapCamera], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            f.write(
                struct.pack(
                    "<iiQQ", cam.id, CAMERA_MODEL_IDS[cam.model], cam.width, cam.height
                )
            )
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(images: Dict[int, ColmapImage], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<ddddddd", *im.qvec, *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(xyz, rgb, path):
    xyz = np.asarray(xyz, dtype=np.float64)
    rgb = np.asarray(rgb, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i, *xyz[i], *rgb[i], 0.0))
            f.write(struct.pack("<Q", 0))
