"""Scene container: dataset + model directory (load branch of ``gsjax.train.scene``).

Loads the dataset's cameras (in the dataset's order: the render path
never shuffles) and a trained model's PLY snapshot from
``<model>/point_cloud/iteration_<N>/point_cloud.ply`` onto a device. A
fresh scene initialized from the SfM point cloud (``load_iteration=None``)
comes with the training slice.
"""

from __future__ import annotations

import os
from typing import List, Optional

from gsjax_torch.configs import ModelParams
from gsjax_torch.data.cameras import Camera
from gsjax_torch.data.dataset_readers import load_camera_images, load_scene_info
from gsjax_torch.models.gaussians import GaussianState, load_gaussian_ply
from gsjax_torch.utils.system import search_for_max_iteration


class Scene:
    def __init__(
        self,
        model: ModelParams,
        load_iteration: Optional[int] = None,
        device="cuda",
    ):
        if load_iteration is None:
            raise NotImplementedError(
                "Scene(load_iteration=None) initializes a model from the SfM "
                "point cloud for training, which comes with the training "
                "slice; pass load_iteration (-1 = latest) to load a model"
            )
        self.model_path = model.model_path
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
        )
        self.cameras_extent = info.radius
        self.train_cameras = load_camera_images(list(info.train_cameras), model.resolution)
        self.test_cameras = load_camera_images(list(info.test_cameras), model.resolution)

        self.gaussians: GaussianState = load_gaussian_ply(
            os.path.join(
                self.model_path, "point_cloud",
                f"iteration_{self.loaded_iter}", "point_cloud.ply",
            ),
            max_sh_degree=model.sh_degree,
            spatial_lr_scale=self.cameras_extent,
            device=device,
        )

    def get_train_cameras(self) -> List[Camera]:
        return self.train_cameras

    def get_test_cameras(self) -> List[Camera]:
        return self.test_cameras
