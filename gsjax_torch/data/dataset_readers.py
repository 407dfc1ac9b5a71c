"""Scene readers: COLMAP reconstructions and Blender/NeRF-synthetic sets.

Functional parity with the reference readers
(reference: scene/dataset_readers.py:45-260) — same splits, the same
nerf++-style normalization (scene radius = 1.1x the max camera-centroid
distance), the same OpenGL->COLMAP axis flip for Blender poses, the same
alpha-compositing of RGBA frames onto the background, the same random
100k-point init for synthetic scenes — but returning plain numpy
:class:`gsjax_torch.data.cameras.Camera` objects and loading images
lazily via a resolution policy identical to the reference's
(utils/camera_utils.py:19-52, auto-cap at 1600 px width). A numpy copy of
``gsjax.data.dataset_readers``; everything here stays on the host.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from gsjax_torch.data import colmap
from gsjax_torch.data.cameras import Camera
from gsjax_torch.data.ply import read_point_cloud_ply, write_point_cloud_ply
from gsjax_torch.utils.camera import focal_to_fov, fov_to_focal, world_to_view
from gsjax_torch.utils.sh import sh_to_rgb


@dataclasses.dataclass(frozen=True)
class BasicPointCloud:
    points: np.ndarray  # (N, 3)
    colors: np.ndarray  # (N, 3) in [0, 1]
    normals: np.ndarray  # (N, 3)


@dataclasses.dataclass
class SceneInfo:
    point_cloud: Optional[BasicPointCloud]
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    translate: np.ndarray
    radius: float
    ply_path: str


def nerfpp_norm(cameras: List[Camera]):
    """Scene centre/radius from camera positions.

    radius = 1.1 * max distance of any camera centre from their centroid
    (reference: scene/dataset_readers.py:45-66).
    """
    centers = np.stack([c.camera_center for c in cameras], axis=0)
    center = centers.mean(axis=0)
    radius = 1.1 * float(np.linalg.norm(centers - center, axis=1).max())
    return -center, radius


def _load_image(path, white_background=False):
    """Load an image -> float32 (H, W, 3) in [0,1] plus optional alpha mask.

    RGBA inputs are alpha-composited onto the background color
    (reference: scene/dataset_readers.py:204-210) and the alpha channel kept
    as a mask (reference: utils/camera_utils.py:44-47).
    """
    from PIL import Image

    im = np.asarray(Image.open(path).convert("RGBA"), dtype=np.float32) / 255.0
    rgb, alpha = im[..., :3], im[..., 3:]
    bg = 1.0 if white_background else 0.0
    return rgb * alpha + bg * (1.0 - alpha), alpha[..., 0]


def resolve_resolution(orig_w, orig_h, resolution=-1, resolution_scale=1.0):
    """The reference's resolution policy (utils/camera_utils.py:22-39).

    ``resolution`` in {1,2,4,8} divides; -1 auto-caps width at 1600 px; any
    other value is a target width.
    """
    if resolution in (1, 2, 4, 8):
        return (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1.0
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def _resize(img, size):
    from PIL import Image

    w, h = size
    if img.shape[1] == w and img.shape[0] == h:
        return img
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return np.asarray(pil.resize((w, h)), dtype=np.float32) / 255.0


def _load_images_parallel(cams, paths, workers: int = 16):
    """Decode camera images with a thread pool (PIL releases the GIL while
    decoding; the reference opens every image serially at scene load,
    dataset_readers.py:68-105)."""
    from concurrent.futures import ThreadPoolExecutor

    def load_one(args):
        cam, pth = args
        image, alpha = _load_image(pth)
        if (alpha == 1.0).all():
            alpha = None
        cam.image, cam.alpha_mask = image, alpha

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(load_one, zip(cams, paths)))


def load_camera_images(cameras, resolution=-1, resolution_scale=1.0):
    """Apply the resolution policy in place; returns the cameras."""
    for cam in cameras:
        w, h = resolve_resolution(cam.width, cam.height, resolution, resolution_scale)
        if cam.image is not None:
            cam.image = _resize(cam.image, (w, h))
            if cam.alpha_mask is not None and (
                cam.alpha_mask.shape[1] != w or cam.alpha_mask.shape[0] != h
            ):
                cam.alpha_mask = _resize(
                    np.repeat(cam.alpha_mask[..., None], 3, -1), (w, h)
                )[..., 0]
        cam.width, cam.height = w, h
    return cameras


def read_colmap_scene(
    path, images_dir="images", eval_split=False, llffhold=8, load_images=True
) -> SceneInfo:
    """Load a COLMAP reconstruction from ``<path>/sparse/0``.

    Split / sorting / ply-conversion semantics match
    reference scene/dataset_readers.py:132-177 (sorted by image name,
    every ``llffhold``-th view held out when ``eval_split``).
    """
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    if os.path.exists(os.path.join(sparse, "images.bin")):
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    else:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    cams: List[Camera] = []
    for im in extr.values():
        cam = intr[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
        else:
            raise ValueError(
                f"COLMAP camera model {cam.model} not supported: undistort first "
                "(only PINHOLE / SIMPLE_PINHOLE)"
            )
        image_name = os.path.basename(im.name).split(".")[0]
        image = alpha = None
        cams.append(
            Camera(
                uid=im.id,
                image_name=image_name,
                R=colmap.qvec_to_rotmat(im.qvec).T,
                T=im.tvec.astype(np.float64),
                fov_x=focal_to_fov(fx, cam.width),
                fov_y=focal_to_fov(fy, cam.height),
                width=cam.width,
                height=cam.height,
                image=image,
                alpha_mask=alpha,
            )
        )
    if load_images:
        _load_images_parallel(
            cams, [os.path.join(path, images_dir, im.name) for im in extr.values()]
        )
    cams.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(cams) if i % llffhold != 0]
        test = [c for i, c in enumerate(cams) if i % llffhold == 0]
    else:
        train, test = cams, []

    translate, radius = nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        if os.path.exists(os.path.join(sparse, "points3D.bin")):
            xyz, rgb, _ = colmap.read_points3d_binary(
                os.path.join(sparse, "points3D.bin")
            )
        else:
            xyz, rgb, _ = colmap.read_points3d_text(
                os.path.join(sparse, "points3D.txt")
            )
        write_point_cloud_ply(ply_path, xyz, rgb)
    xyz, rgb, normals = read_point_cloud_ply(ply_path)
    pcd = BasicPointCloud(points=xyz, colors=rgb, normals=normals)
    return SceneInfo(pcd, train, test, translate, radius, ply_path)


def read_blender_scene(
    path, white_background=False, eval_split=False, extension=".png", load_images=True
) -> SceneInfo:
    """Load a Blender / NeRF-synthetic scene (transforms_{train,test}.json).

    Axis conventions and random-point init per
    reference scene/dataset_readers.py:179-255.
    """

    def read_transforms(fname, uid0):
        with open(os.path.join(path, fname)) as f:
            meta = json.load(f)
        fov_x = meta["camera_angle_x"]
        out = []
        for i, frame in enumerate(meta["frames"]):
            file_path = frame["file_path"]
            if not os.path.splitext(file_path)[1]:
                file_path = file_path + extension
            img_path = os.path.join(path, file_path)
            c2w = np.array(frame["transform_matrix"], dtype=np.float64)
            c2w[:3, 1:3] *= -1  # OpenGL (Y up, Z back) -> COLMAP (Y down, Z fwd)
            w2c = np.linalg.inv(c2w)
            image = alpha = None
            if load_images:
                image, alpha = _load_image(img_path, white_background)
                h, w = image.shape[:2]
            else:
                from PIL import Image

                with Image.open(img_path) as im:
                    w, h = im.size
            out.append(
                Camera(
                    uid=uid0 + i,
                    image_name=Path(file_path).stem,
                    R=w2c[:3, :3].T,
                    T=w2c[:3, 3],
                    fov_x=fov_x,
                    fov_y=focal_to_fov(fov_to_focal(fov_x, w), h),
                    width=w,
                    height=h,
                    image=image,
                    alpha_mask=alpha,
                )
            )
        return out

    train = read_transforms("transforms_train.json", 0)
    test = (
        read_transforms("transforms_test.json", len(train))
        if os.path.exists(os.path.join(path, "transforms_test.json"))
        else []
    )
    if not eval_split:
        train = train + test
        test = []

    translate, radius = nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        rgb = sh_to_rgb(rng.random((num_pts, 3)) / 255.0)
        write_point_cloud_ply(ply_path, xyz, rgb * 255)
    xyz, rgb, normals = read_point_cloud_ply(ply_path)
    pcd = BasicPointCloud(points=xyz, colors=rgb, normals=normals)
    return SceneInfo(pcd, train, test, translate, radius, ply_path)


def load_scene_info(source_path, **kwargs) -> SceneInfo:
    """Auto-detect scene type (reference: scene/__init__.py:43-49)."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        kwargs.pop("white_background", None)
        kwargs.pop("extension", None)
        return read_colmap_scene(source_path, **kwargs)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        kwargs.pop("images_dir", None)
        kwargs.pop("llffhold", None)
        return read_blender_scene(source_path, **kwargs)
    raise ValueError(f"Could not recognize scene type at {source_path}")


def camera_to_json(idx, camera: Camera):
    """cameras.json entry (reference: utils/camera_utils.py:62-82)."""
    w2c = world_to_view(camera.R, camera.T)
    c2w = np.linalg.inv(w2c)
    return {
        "id": idx,
        "img_name": camera.image_name,
        "width": int(camera.width),
        "height": int(camera.height),
        "position": c2w[:3, 3].tolist(),
        "rotation": [row.tolist() for row in c2w[:3, :3]],
        "fy": fov_to_focal(camera.fov_y, camera.height),
        "fx": fov_to_focal(camera.fov_x, camera.width),
    }
