"""Scene container: dataset + model directory (load branch of ``gsjax.train.scene``).

Loads the dataset's cameras (in the dataset's order) and either a trained
model's PLY snapshot from
``<model>/point_cloud/iteration_<N>/point_cloud.ply`` or, with
``load_iteration=None``, a fresh model initialized from the dataset's SfM
point cloud (``create_from_pcd``), onto a device.
"""

from __future__ import annotations

import os
from typing import List, Optional

from gsjax_torch.configs import ModelParams
from gsjax_torch.data.cameras import Camera
from gsjax_torch.data.dataset_readers import load_camera_images, load_scene_info
from gsjax_torch.models.gaussians import GaussianState, create_from_pcd, load_gaussian_ply
from gsjax_torch.utils.system import search_for_max_iteration


class Scene:
    def __init__(
        self,
        model: ModelParams,
        load_iteration: Optional[int] = None,
        device="cuda",
        capacity: Optional[int] = None,
    ):
        self.model_path = model.model_path
        self.loaded_iter = None
        if load_iteration == -1:
            self.loaded_iter = search_for_max_iteration(
                os.path.join(self.model_path, "point_cloud")
            )
        elif load_iteration is not None:
            self.loaded_iter = load_iteration
        if self.loaded_iter:
            print(f"Loading trained model at iteration {self.loaded_iter}")

        info = load_scene_info(
            model.source_path,
            images_dir=model.images,
            eval_split=model.eval,
            white_background=model.white_background,
        )
        self.cameras_extent = info.radius
        self.train_cameras = load_camera_images(list(info.train_cameras), model.resolution)
        self.test_cameras = load_camera_images(list(info.test_cameras), model.resolution)

        if self.loaded_iter:
            self.gaussians: GaussianState = load_gaussian_ply(
                os.path.join(
                    self.model_path, "point_cloud",
                    f"iteration_{self.loaded_iter}", "point_cloud.ply",
                ),
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

    def get_train_cameras(self) -> List[Camera]:
        return self.train_cameras

    def get_test_cameras(self) -> List[Camera]:
        return self.test_cameras
