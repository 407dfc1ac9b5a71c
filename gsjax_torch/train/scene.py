"""Scene container: dataset + model directory (torch).

Counterpart of ``gsjax.train.scene`` (reference: scene/__init__.py:25-92):
loads the dataset, prepares the output directory (``cameras.json`` and the
``input.ply`` copy for a fresh model), shuffles the cameras with Python's
``random`` as gsjax does, tracks the scene extent, loads a trained model's
PLY snapshot (``<model>/point_cloud/iteration_<N>/point_cloud.ply``) or
initializes one from the dataset's SfM point cloud onto ``device``, and
saves PLY snapshots.
"""

from __future__ import annotations

import json
import os
import random
import shutil
from typing import List, Optional

from gsjax_torch.configs import ModelParams
from gsjax_torch.data.cameras import Camera
from gsjax_torch.data.dataset_readers import camera_to_json, load_camera_images, load_scene_info
from gsjax_torch.models.gaussians import (
    GaussianState,
    create_from_pcd,
    load_gaussian_ply,
    save_gaussian_ply,
)
from gsjax_torch.utils.system import resolve_device, search_for_max_iteration


class Scene:
    def __init__(
        self,
        model: ModelParams,
        load_iteration: Optional[int] = None,
        shuffle: bool = True,
        resolution_scales=(1.0,),
        load_images: bool = True,
        capacity: Optional[int] = None,
        device="cuda",
    ):
        device = resolve_device(device)  # fail before reading or writing anything
        self.model_path = model.model_path
        self.loaded_iter = None
        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_for_max_iteration(
                    os.path.join(self.model_path, "point_cloud")
                )
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        info = load_scene_info(
            model.source_path,
            images_dir=model.images,
            eval_split=model.eval,
            white_background=model.white_background,
            load_images=load_images,
        )

        if not self.loaded_iter:
            os.makedirs(self.model_path, exist_ok=True)
            shutil.copyfile(info.ply_path, os.path.join(self.model_path, "input.ply"))
            cam_json = [camera_to_json(i, c)
                        for i, c in enumerate(info.train_cameras + info.test_cameras)]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        if shuffle:
            random.shuffle(info.train_cameras)
            random.shuffle(info.test_cameras)

        self.cameras_extent = info.radius
        self.train_cameras = {}
        self.test_cameras = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = load_camera_images(
                list(info.train_cameras), model.resolution, scale)
            self.test_cameras[scale] = load_camera_images(
                list(info.test_cameras), model.resolution, scale)

        if self.loaded_iter:
            self.gaussians: GaussianState = load_gaussian_ply(
                os.path.join(self.model_path, "point_cloud",
                             f"iteration_{self.loaded_iter}", "point_cloud.ply"),
                max_sh_degree=model.sh_degree,
                spatial_lr_scale=self.cameras_extent,
                capacity=capacity,
                device=device,
            )
        else:
            self.gaussians = create_from_pcd(
                info.point_cloud.points,
                info.point_cloud.colors,
                spatial_lr_scale=self.cameras_extent,
                max_sh_degree=model.sh_degree,
                capacity=capacity,
                device=device,
            )

    def save(self, iteration: int, state: Optional[GaussianState] = None):
        out = os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}")
        os.makedirs(out, exist_ok=True)
        save_gaussian_ply(state if state is not None else self.gaussians,
                          os.path.join(out, "point_cloud.ply"))

    def get_train_cameras(self, scale=1.0) -> List[Camera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale=1.0) -> List[Camera]:
        return self.test_cameras[scale]
