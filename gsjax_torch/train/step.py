"""The train step and render helpers (torch).

Counterpart of ``gsjax.train.step``. One iteration
(:func:`_train_step_body`): camera selection, render, 0.8 L1 + 0.2 (1 -
SSIM), backward, per-group Adam, densification statistics (reference:
train.py:51-128). On CUDA the render goes through the compositing
kernels: the training forward, the backward and the reduction to
gaussians (``ops/cuda_composite.py``); autograd carries the gradients on
through preprocess and the activations.

Gradient-stat plumbing, as gsjax: instead of the reference's zero-tensor
``retain_grad`` hack the render takes an explicit zero ``means2d_offset``
that requires grad; its gradient is the per-Gaussian screen-space gradient
densification reads.

``apply_update=False`` renders, accumulates densification statistics and
reports metrics but skips the Adam step, so parameters, moments and count
stay as they were — the reference's densify-iteration behaviour (gsjax's
``training(densify_iter_grad="discard")``).
"""

from __future__ import annotations

import dataclasses

import torch

import numpy as np

from gsjax_torch.data.cameras import RenderCamera, index_render_camera
from gsjax_torch.models.densify import (
    DensifyConfig,
    add_densification_stats,
    densify_and_prune,
    reset_opacity,
)
from gsjax_torch.models.gaussians import GaussianState, activated
from gsjax_torch.ops.rasterize import RasterizeSettings, render
from gsjax_torch.train.loss import l1_loss, ssim
from gsjax_torch.train.optim import adam_moments, with_adam_moments
from gsjax_torch.utils import prng
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


def quantize(img: torch.Tensor) -> torch.Tensor:
    """A float [0, 1] image as uint8, rounding half up: the one
    quantization of every served frame (``make_render_fn(as_uint8=True)``,
    the SIBR bridge), so frames are bit-identical whichever path made them."""
    return torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


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
            img = quantize(img)
        if with_stats:
            return img, out["num_dropped"]
        return img

    render_fn.settings = cfg.settings  # the budgets it renders with
    return render_fn


def _activated_from(params):
    """Post-activation attributes of a parameter dict (differentiable)."""
    scales = torch.exp(params["scaling"])
    quats = safe_normalize(params["rotation"])
    opac = torch.sigmoid(params["opacity"][:, 0])
    shs = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    return params["xyz"], scales, quats, opac, shs


def _train_step_body(tx, cameras, images, cfg: TrainConfig, bg_color,
                     state: GaussianState, opt_state, cam_idx, key=None,
                     apply_update=None):
    """One iteration. ``opt_state`` is the optimizer ``tx.init`` made over
    ``state.params``; it updates them in place. ``key`` is a
    ``utils.prng`` key (needed only with ``random_background``: the
    background is ``uniform(key, (3,))``, gsjax's draw). Returns
    ``(state, opt_state, metrics)``; the metrics are 0-d device tensors."""
    if opt_state.lr_fns is not tx.lr_fns:
        raise ValueError("opt_state was not made by this step's optimizer")
    params = state.params
    if any(opt_state.param(k) is not v for k, v in params.items()):
        raise ValueError("opt_state is not bound to state.params (tx.init(state.params); "
                         "after grow_capacity, train.optim.grow_optimizer)")
    camera = index_render_camera(cameras, cam_idx)
    dev = state.device
    gt = images[int(cam_idx)]
    if gt.dtype == torch.uint8:
        gt = gt.to(torch.float32) / 255.0
    if cfg.random_background:
        if key is None:
            raise ValueError("random_background needs a key")
        bg = prng.uniform(key, (3,), dev)
    else:
        bg = bg_color
    offset = torch.zeros((state.capacity, 2), dtype=torch.float32, device=dev,
                         requires_grad=True)

    with torch.enable_grad():
        means3d, scales, quats, opac, shs = _activated_from(params)
        cov3d = colors = None
        if cfg.compute_cov3d_python:
            cov3d = strip_symmetric(build_covariance(scales, quats, 1.0))
        if cfg.convert_shs_python:
            dirs = safe_normalize(means3d - camera.camera_center[None, :])
            colors = torch.clamp_min(eval_sh(shs, dirs, state.active_sh_degree) + 0.5, 0.0)
        out = render(
            camera, means3d, scales, quats, opac, shs, state.active_sh_degree, bg,
            cfg.settings, active_mask=state.active, means2d_offset=offset,
            cov3d_precomp=cov3d, colors_precomp=colors,
        )
        img = out["render"]
        ll1 = l1_loss(img, gt)
        loss = (1.0 - cfg.lambda_dssim) * ll1 + cfg.lambda_dssim * (1.0 - ssim(img, gt))
    opt_state.zero_grad(set_to_none=True)
    loss.backward()
    if apply_update is None or bool(apply_update):
        # a parameter the loss does not reach (f_rest at SH degree 0) still
        # takes its Adam step with a zero gradient, as in optax
        for v in params.values():
            if v.grad is None:
                v.grad = torch.zeros_like(v)
        opt_state.step()
    opt_state.zero_grad(set_to_none=True)

    g_offset = offset.grad if offset.grad is not None else torch.zeros_like(offset)
    new_state = add_densification_stats(
        state, g_offset, out["radii"], camera.width, camera.height)
    metrics = {
        "loss": loss.detach(),
        "l1": ll1.detach(),
        "num_dropped_pairs": out["num_dropped"],
        "num_mt_capped_pairs": out["num_mt_capped"],
        "num_tier_capped_pairs": out["num_tier_capped"],
        "num_tile_capped": out["num_tile_capped"],
        "num_active": new_state.num_active,
    }
    return new_state, opt_state, metrics


def _bg_and_images(cameras, images, cfg: TrainConfig):
    dev = cameras[0].world_view.device
    bg_color = torch.full((3,), 1.0 if cfg.white_background else 0.0,
                          dtype=torch.float32, device=dev)
    return bg_color, torch.as_tensor(images).to(dev)


def make_train_step(tx, cameras, images, cfg: TrainConfig):
    """Build the train step.

    ``step(state, opt_state, cam_idx, key=None, apply_update=None) ->
    (state, opt_state, metrics)``. ``cameras`` is a batch of
    ``data.cameras.stack_render_cameras``; ``images`` (M, H, W, 3) float32
    in [0, 1] or uint8 (numpy or tensor) moves to the cameras' device once,
    and uint8 converts there each step. ``apply_update=False`` drops the
    Adam update (see the module docstring)."""
    bg_color, images = _bg_and_images(cameras, images, cfg)

    def step(state, opt_state, cam_idx, key=None, apply_update=None):
        return _train_step_body(tx, cameras, images, cfg, bg_color, state, opt_state,
                                cam_idx, key, apply_update)

    return step


def make_train_step_chained(tx, cameras, images, cfg: TrainConfig, n_steps: int):
    """``n_steps`` full train steps in one call, for event-free iteration
    ranges (gsjax scans them in one dispatch; here a Python loop).

    ``chained(state, opt_state, cam_idxs (n_steps,), key=None) ->
    (state, opt_state, metrics of the last step + "loss_mean")``, the
    counters reduced over the steps exactly as gsjax does; step ``i``
    takes the key ``fold_in(key, i)``, as gsjax's scan."""
    bg_color, images = _bg_and_images(cameras, images, cfg)

    def chained(state, opt_state, cam_idxs, key=None):
        ms = []
        for i in range(n_steps):
            k = None if key is None else prng.fold_in(key, i)
            state, opt_state, m = _train_step_body(
                tx, cameras, images, cfg, bg_color, state, opt_state, cam_idxs[i], k)
            ms.append(m)
        stacked = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        metrics = {k: v[-1] for k, v in stacked.items()}
        metrics["loss_mean"] = stacked["loss"].mean()
        for k in ("num_dropped_pairs", "num_mt_capped_pairs", "num_tier_capped_pairs",
                  "num_tile_capped"):
            metrics[k] = stacked[k].max()
        # budget drops are differenced per step, then reduced: max(dropped)
        # - max(capped) across different steps can read 0 even when one
        # step dropped pairs to the global budget
        metrics["num_budget_dropped"] = (
            stacked["num_dropped_pairs"] - stacked["num_mt_capped_pairs"]).max()
        metrics["num_mt_only_capped"] = (
            stacked["num_mt_capped_pairs"] - stacked["num_tier_capped_pairs"]).max()
        return state, opt_state, metrics

    return chained


@torch.no_grad()
def _rebind(state: GaussianState, new: GaussianState) -> GaussianState:
    """``new`` with its parameters written into ``state``'s parameter
    tensors, in place: the optimizer stays bound to them (capacity is fixed
    between growths)."""
    for k, v in new.params.items():
        state.params[k].copy_(v)
    return dataclasses.replace(new, params=state.params)


def make_densify_step(opt, cfg: TrainConfig):
    """The densification and opacity-reset steps (gsjax's
    ``make_densify_step``), over a state and the optimizer bound to its
    parameters:

    ``densify_step(state, opt_state, key, use_screen_size, eps=None) ->
    (state, opt_state, stats)`` and ``opacity_reset_step(state, opt_state)
    -> (state, opt_state)``. ``key`` is the split noise's ``utils.prng``
    key (or ``eps``, see ``models.densify.densify_and_prune``). The
    parameters are written in place, the moments are zeroed at every
    written slot, and the optimizer's counts stay."""
    dcfg = DensifyConfig(
        grad_threshold=opt.densify_grad_threshold,
        percent_dense=opt.percent_dense,
    )

    def densify_step(state, opt_state, key, use_screen_size: bool, eps=None):
        mu, nu = adam_moments(opt_state)
        new, mu, nu, stats = densify_and_prune(
            state, mu, nu, key, cfg.extent, dcfg, use_screen_size=use_screen_size, eps=eps)
        return _rebind(state, new), with_adam_moments(opt_state, mu, nu), stats

    def opacity_reset_step(state, opt_state):
        mu, nu = adam_moments(opt_state)
        new, mu, nu = reset_opacity(state, mu, nu, dcfg)
        return _rebind(state, new), with_adam_moments(opt_state, mu, nu)

    return densify_step, opacity_reset_step


def stack_images(cameras_list, dtype=np.uint8):
    """Stack per-camera GT images (applying alpha masks, reference
    scene/cameras.py:39-46) into one (M, H, W, 3) numpy array."""
    imgs = []
    for cam in cameras_list:
        img = cam.image
        if cam.alpha_mask is not None:
            img = img * cam.alpha_mask[..., None]
        if dtype == np.uint8:
            img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        imgs.append(img)
    return np.stack(imgs)
