"""Render helpers of the train step (render half of ``gsjax.train.step``).

The training step itself (loss, backward, optimizer, densification stats)
comes with the training slice, together with the backward kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.data.cameras import RenderCamera
from gsjax_torch.models.gaussians import GaussianState, activated
from gsjax_torch.ops.rasterize import RasterizeSettings, render
from gsjax_torch.utils.math import build_covariance, safe_normalize, strip_symmetric
from gsjax_torch.utils.sh import eval_sh


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    settings: RasterizeSettings = RasterizeSettings()
    lambda_dssim: float = 0.2
    white_background: bool = False
    random_background: bool = False
    extent: float = 1.0  # scene radius (cameras_extent)
    # the reference's dual-path toggles (PipelineParams; reference
    # gaussian_renderer/__init__.py:62-80): pre-compute covariance / SH->RGB
    # outside the rasterizer instead of inside its preprocess
    compute_cov3d_python: bool = False
    convert_shs_python: bool = False


def render_state(
    state: GaussianState,
    camera: RenderCamera,
    bg,
    settings: RasterizeSettings,
    *,
    scale_modifier=1.0,
    sh_degree=None,
    means2d_offset=None,
):
    """Render the active Gaussians of ``state`` through ``camera``."""
    means3d, scales, quats, opac, shs = activated(state)
    return render(
        camera, means3d, scales, quats, opac, shs,
        state.active_sh_degree if sh_degree is None else sh_degree,
        bg, settings,
        scale_modifier=scale_modifier,
        active_mask=state.active,
        means2d_offset=means2d_offset,
    )


def make_render_fn(
    cfg: TrainConfig, with_stats: bool = False, as_uint8: bool = False
):
    """A ``(state, camera, bg, scale_modifier=1.0, *, shs_python=False,
    cov3d_python=False) -> image`` function for eval / viewer use. It runs
    without autograd, so the kernel backend applies on CUDA.

    ``as_uint8=True`` quantizes to uint8 on the device before the image
    leaves it (4x fewer bytes to the host). ``shs_python`` / ``cov3d_python``
    are the reference's dual-path toggles: SH->RGB and the 3D covariance
    computed outside the rasterizer's preprocess. ``with_stats=True``
    returns ``(image, num_dropped)`` — the pair-drop counter inference
    callers must check, since inference never regrows its budgets."""

    @torch.no_grad()
    def render_fn(
        state: GaussianState,
        camera: RenderCamera,
        bg,
        scale_modifier=1.0,
        *,
        shs_python: bool = False,
        cov3d_python: bool = False,
    ):
        means3d, scales, quats, opac, shs = activated(state)
        cov3d = colors = None
        if cov3d_python:
            cov3d = strip_symmetric(build_covariance(scales, quats, scale_modifier))
        if shs_python:
            dirs = safe_normalize(means3d - camera.camera_center[None, :])
            colors = torch.clamp_min(
                eval_sh(shs, dirs, state.active_sh_degree) + 0.5, 0.0
            )
        out = render(
            camera, means3d, scales, quats, opac, shs,
            state.active_sh_degree, bg, cfg.settings,
            scale_modifier=scale_modifier,
            active_mask=state.active,
            cov3d_precomp=cov3d,
            colors_precomp=colors,
        )
        img = out["render"]
        if as_uint8:
            img = torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
        if with_stats:
            return img, out["num_dropped"]
        return img

    return render_fn
