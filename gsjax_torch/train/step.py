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

gsjax jit-compiles the step, the chained dispatch and the render; on a
card the port captures each as a CUDA graph (``utils.graphs``) and
replays it, and ``eager=True`` runs the same ops one by one (the CPU
always does). The device's half of a step reads nothing back to the host
and every tensor it writes keeps its address; the host's half (camera
indices, Adam's row, random backgrounds) goes into the graph's buffers.

Each dispatch and frame is a call of ``utils.profiling``'s registry: spans
time its host half (``dispatch.prepare``, ``dispatch.bind``,
``dispatch.copy_in``, ``dispatch.eager``; ``frame.bind``,
``frame.copy_in``), counters count the items each path ran
(``train.graph``, ``train.capture``, ``train.eager``, and ``view.*``), and
the layer clock's marks split an iteration into ``prep``,
``composite_fwd``, ``loss``, ``composite_bwd``, ``reduce``, ``prep_bwd``,
``adam`` and ``stats``, a frame into ``copy_in``, ``prep``,
``composite_infer`` and ``finish``.
"""

from __future__ import annotations

import dataclasses

import torch

import numpy as np

from gsjax_torch.data.cameras import (
    CAMERA_TENSORS, RenderCamera, RenderCameraBatch, index_render_camera, stack_render_cameras,
    take_row,
)
from gsjax_torch.models.densify import (
    DensifyConfig,
    add_densification_stats_,
    densify_and_prune,
    reset_opacity,
)
from gsjax_torch.models.gaussians import GaussianState, activated
from gsjax_torch.ops.rasterize import RasterizeSettings, render
from gsjax_torch.train.loss import l1_loss, ssim
from gsjax_torch.train import optim
from gsjax_torch.train.optim import adam_moments, write_adam_moments
from gsjax_torch.utils import graphs, profiling, prng
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
    cfg: TrainConfig, with_stats: bool = False, as_uint8: bool = False, *,
    eager: bool = False,
):
    """A ``(state, camera, bg, scale_modifier=1.0, *, shs_python=False,
    cov3d_python=False) -> image`` function for eval / viewer use. It runs
    without autograd, so the kernel backend applies on CUDA.

    ``as_uint8=True`` quantizes to uint8 on the device before the image
    leaves it (4x fewer bytes to the host). ``shs_python`` / ``cov3d_python``
    are the reference's dual-path toggles: SH->RGB and the 3D covariance
    computed outside the rasterizer's preprocess. ``with_stats=True``
    returns ``(image, num_dropped)`` — the pair-drop counter inference
    callers must check, since inference never regrows its budgets.

    On a card each frame replays a CUDA graph (``utils.graphs``), one per
    (capacity, SH degree, resolution, ``scale_modifier``, ``shs_python``,
    ``cov3d_python``), as gsjax's ``jit`` compiles one program per shape:
    the state's parameters and active mask, the camera and the background
    are copied into the graph's buffers (~0.2 ms at 1M gaussians), and the
    frame is a copy of the graph's output, the same bits as the eager
    frame. ``eager=True`` (and any CPU state) runs the frame op by op."""

    def frame(state, camera, bg, scale_modifier, shs_python, cov3d_python):
        profiling.mark_start()
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
        out = (img, out["num_dropped"]) if with_stats else img
        profiling.mark("finish")
        return out

    cache = graphs.GraphCache()

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
        with profiling.call("frame", "view", 1) as call:
            dev = state.device
            if eager or dev.type != "cuda":
                call.take("eager")
                profiling.mark_start()
                profiling.mark("copy_in")  # the eager frame reads the state in place
                return frame(state, camera, bg, scale_modifier, shs_python, cov3d_python)

            def make():
                # the graph renders its own copy of the model: callers pass new
                # parameter tensors (render_bench perturbs xyz every frame), and
                # a captured train step changes the live ones without a trace
                own = dataclasses.replace(
                    state, params={k: torch.empty_like(v) for k, v in state.params.items()},
                    active=torch.empty_like(state.active))
                cam = RenderCamera(**{k: torch.empty_like(getattr(camera, k), device=dev)
                                      for k in CAMERA_TENSORS},
                                   width=camera.width, height=camera.height)
                bg_buf = torch.empty(3, dtype=torch.float32, device=dev)
                g = graphs.Graph(lambda: frame(own, cam, bg_buf, float(scale_modifier),
                                               shs_python, cov3d_python), dev)
                return own, cam, bg_buf, g

            with profiling.span("frame.bind"):
                key = (state.capacity, state.active_sh_degree, camera.width, camera.height,
                       float(scale_modifier), bool(shs_python), bool(cov3d_python))
                own, cam, bg_buf, g = cache.get(key, (), make)
            call.take("graph" if g.graph is not None else "capture")
            with profiling.span("frame.copy_in"):
                profiling.mark_start()
                for k, v in state.params.items():
                    own.params[k].copy_(v)
                own.active.copy_(state.active)
                for k in CAMERA_TENSORS:
                    graphs.pin_copy_(getattr(cam, k), getattr(camera, k))
                graphs.pin_copy_(bg_buf, bg)
                profiling.mark("copy_in")
            return g()

    render_fn.settings = cfg.settings  # the budgets it renders with
    render_fn.graphs = cache
    return render_fn


def _activated_from(params):
    """Post-activation attributes of a parameter dict (differentiable)."""
    scales = torch.exp(params["scaling"])
    quats = safe_normalize(params["rotation"])
    opac = torch.sigmoid(params["opacity"][:, 0])
    shs = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    return params["xyz"], scales, quats, opac, shs


def _check_bound(tx, state: GaussianState, opt_state):
    if opt_state.lr_fns is not tx.lr_fns:
        raise ValueError("opt_state was not made by this step's optimizer")
    if any(opt_state.param(k) is not v for k, v in state.params.items()):
        raise ValueError("opt_state is not bound to state.params (tx.init(state.params); "
                         "after grow_capacity, train.optim.grow_optimizer)")


def _train_step_body(cameras, images, cfg: TrainConfig, state: GaussianState, opt_state,
                     cam_idx, bg, adam_row, apply_update: bool = True):
    """The device's half of one iteration, the same ops whether it runs
    eagerly or is captured: the host reads nothing from the device here.
    ``cam_idx`` is a 0-d int64 tensor, ``bg`` a (3,) tensor and
    ``adam_row`` the step's :meth:`GaussianAdam.advance` row, all on the
    state's device. The parameters and Adam's moments update in place
    (``opt_state`` is the optimizer ``tx.init`` made over ``state.params``),
    and so do the densification statistics. Returns the metrics, 0-d
    device tensors."""
    profiling.mark_start()
    camera = index_render_camera(cameras, cam_idx)
    dev = state.device
    gt = take_row(images, cam_idx)
    if gt.dtype == torch.uint8:
        gt = gt.to(torch.float32) / 255.0
    params = state.params
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
    profiling.mark("prep_bwd")
    if apply_update:
        # a parameter the loss does not reach (f_rest at SH degree 0) still
        # takes its Adam step with a zero gradient, as in optax
        for v in params.values():
            if v.grad is None:
                v.grad = torch.zeros_like(v)
        opt_state.update(adam_row)
    profiling.mark("adam")
    opt_state.zero_grad(set_to_none=True)

    g_offset = offset.grad if offset.grad is not None else torch.zeros_like(offset)
    add_densification_stats_(state, g_offset, out["radii"], camera.width, camera.height)
    metrics = {
        "loss": loss.detach(),
        "l1": ll1.detach(),
        "num_dropped_pairs": out["num_dropped"],
        "num_mt_capped_pairs": out["num_mt_capped"],
        "num_tier_capped_pairs": out["num_tier_capped"],
        "num_tile_capped": out["num_tile_capped"],
        "num_active": state.num_active,
    }
    profiling.mark("stats")
    return metrics


def _chained_body(cameras, images, cfg, state, opt_state, cam_idxs, bgs, rows):
    """``len(cam_idxs)`` iterations, step ``i`` reading row ``i`` of the
    (n,) camera indices, (n, 3) backgrounds and (n, ROW_W) Adam rows, and
    gsjax's reduction of their metrics: the last step's, ``loss_mean``,
    the counters' maxima and the per-step differences' maxima."""
    ms = [_train_step_body(cameras, images, cfg, state, opt_state, cam_idxs[i], bgs[i],
                           rows[i]) for i in range(cam_idxs.shape[0])]
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
    return metrics


def _bg_and_images(cameras, images, cfg: TrainConfig):
    dev = cameras[0].world_view.device
    bg_color = torch.full((3,), 1.0 if cfg.white_background else 0.0,
                          dtype=torch.float32, device=dev)
    return bg_color, torch.as_tensor(images).to(dev)


class _Dispatch:
    """A train step (``chained=False``: one iteration) or a chained
    dispatch of ``n`` iterations over one camera batch.

    A call does the host's half first: each step's camera index, Adam row
    (:meth:`GaussianAdam.advance`, which moves the counts on) and, under
    ``random_background``, its background drawn with gsjax's key
    (``utils.prng``, on the device); the registry counts the steps each
    path runs (``train.graph``: a replay; ``train.capture``: a new graph's
    warm-up; ``train.eager``: op by op). On a card it then writes them into a
    captured graph's static buffers and replays it (``utils.graphs``): one
    graph per (capacity, SH degree, ``apply_update``) and the state's and
    moments' tensors, as gsjax's ``jit`` compiles per shape and per
    ``apply_update`` (the step's closure fixes the camera batch, so the
    resolution, and the settings). With ``eager``, on the CPU, and with the
    scan backend (``RasterizeSettings.backend="scan"``: the backward of its
    ``torch.cumprod`` asks the device whether an input is zero, which a
    capture refuses) the same device half runs op by op on the same
    rows."""

    def __init__(self, tx, cameras, images, cfg: TrainConfig, n: int, chained: bool,
                 eager: bool):
        if not isinstance(cameras, RenderCameraBatch):  # a list of cameras
            cameras = stack_render_cameras(cameras, cameras[0].world_view.device)
        self.tx, self.cameras, self.cfg = tx, cameras, cfg
        self.bg_color, self.images = _bg_and_images(cameras, images, cfg)
        self.n, self.chained = n, chained
        self.eager = eager or cfg.settings.backend == "scan"
        self.graphs = graphs.GraphCache()

    def body(self, state, opt_state, cam_idxs, bgs, rows, apply):
        if self.chained:
            return _chained_body(self.cameras, self.images, self.cfg, state, opt_state,
                                 cam_idxs, bgs, rows)
        return _train_step_body(self.cameras, self.images, self.cfg, state, opt_state,
                                cam_idxs[0], bgs[0], None if rows is None else rows[0],
                                apply)

    def __call__(self, state, opt_state, cam_idxs, keys, apply: bool):
        with profiling.call("dispatch", "train", self.n) as call:
            dev = state.device
            with profiling.span("dispatch.prepare"):
                _check_bound(self.tx, state, opt_state)
                if self.cfg.random_background and any(k is None for k in keys):
                    raise ValueError("random_background needs a key")
                cam_idxs = [int(i) for i in cam_idxs]
                if not all(0 <= i < len(self.cameras) for i in cam_idxs):
                    # the device gathers the camera: an index out of range would
                    # be a device-side assert there, not an error here
                    raise IndexError(f"camera indices {cam_idxs} out of range for "
                                     f"{len(self.cameras)} cameras")
                opt_state.init_state()
                rows = [opt_state.advance() for _ in range(self.n)] if apply else None
                draws = ([prng.uniform(k, (3,), dev) for k in keys]
                         if self.cfg.random_background else None)
            if self.eager or dev.type != "cuda":
                call.take("eager")
                with profiling.span("dispatch.eager"):
                    cams = graphs.pin_copy_(torch.empty(self.n, dtype=torch.int64, device=dev),
                                            cam_idxs)
                    bgs = torch.stack(draws) if draws else self.bg_color.expand(self.n, 3)
                    adam = None if rows is None else graphs.pin_copy_(
                        torch.empty((self.n, optim.ROW_W), device=dev), rows)
                    return state, opt_state, self.body(state, opt_state, cams, bgs, adam, apply)

            def make():
                cams = torch.zeros(self.n, dtype=torch.int64, device=dev)
                bgs = self.bg_color.repeat(self.n, 1)
                adam = torch.zeros((self.n, optim.ROW_W), dtype=torch.float32, device=dev)
                g = graphs.Graph(lambda: self.body(state, opt_state, cams, bgs,
                                                   adam if apply else None, apply), dev)
                return cams, bgs, adam, g

            with profiling.span("dispatch.bind"):
                key = (state.capacity, state.active_sh_degree, apply)
                mu, nu = adam_moments(opt_state)
                binding = graphs.addresses(*state.params.values(), state.active,
                                           state.max_radii2d, state.xyz_grad_accum, state.denom,
                                           *mu.values(), *nu.values())
                cams, bgs, adam, g = self.graphs.get(key, binding, make)
            with profiling.span("dispatch.copy_in"):
                graphs.pin_copy_(cams, cam_idxs)
                if rows is not None:
                    graphs.pin_copy_(adam, rows)
                for i, d in enumerate(draws or ()):
                    bgs[i].copy_(d)
            call.take("capture" if g.graph is None else "graph")
            return state, opt_state, g()


def make_train_step(tx, cameras, images, cfg: TrainConfig, *, eager: bool = False):
    """Build the train step.

    ``step(state, opt_state, cam_idx, key=None, apply_update=None) ->
    (state, opt_state, metrics)``. ``cameras`` is a
    ``data.cameras.stack_render_cameras`` batch (a list of same-size
    render cameras is stacked); ``images`` (M, H, W, 3)
    float32 in [0, 1] or uint8 (numpy or tensor) moves to the cameras'
    device once, and uint8 converts there each step. ``key`` is a
    ``utils.prng`` key (needed only with ``random_background``: the
    background is ``uniform(key, (3,))``, gsjax's draw).
    ``apply_update=False`` (a host bool) drops the Adam update (see the
    module docstring). The state and the optimizer update in place and
    come back as they went in.

    On a card the step replays a captured CUDA graph (:class:`_Dispatch`;
    the scan backend's steps run eager); ``eager=True`` runs it op by op,
    as on the CPU. ``step.graphs`` is the step's graph cache."""
    dispatch = _Dispatch(tx, cameras, images, cfg, 1, False, eager)

    def step(state, opt_state, cam_idx, key=None, apply_update=None):
        apply = apply_update is None or bool(apply_update)
        return dispatch(state, opt_state, [cam_idx], [key], apply)

    step.graphs = dispatch.graphs
    return step


def make_train_step_chained(tx, cameras, images, cfg: TrainConfig, n_steps: int, *,
                            eager: bool = False):
    """``n_steps`` full train steps in one call, for event-free iteration
    ranges (gsjax scans them in one dispatch).

    ``chained(state, opt_state, cam_idxs (n_steps,), key=None) ->
    (state, opt_state, metrics of the last step + "loss_mean")``, the
    counters reduced over the steps exactly as gsjax does; step ``i``
    takes the key ``fold_in(key, i)``, as gsjax's scan. On a card the
    whole dispatch is one captured CUDA graph, replayed once, its steps
    reading their rows of static (n_steps, ...) buffers; ``eager=True``
    runs the same steps op by op, as on the CPU."""
    dispatch = _Dispatch(tx, cameras, images, cfg, n_steps, True, eager)

    def chained(state, opt_state, cam_idxs, key=None):
        keys = [None if key is None else prng.fold_in(key, i) for i in range(n_steps)]
        return dispatch(state, opt_state, list(cam_idxs), keys, True)

    chained.graphs = dispatch.graphs
    return chained


@torch.no_grad()
def snapshot(state: GaussianState, opt_state) -> dict:
    """Copies of everything a train step reads and writes: the
    parameters, the statistics, the active mask, Adam's moments (which it
    makes if missing) and counts. :func:`restore` writes one back in place,
    so a captured step stays bound; two snapshots compare key by key."""
    opt_state.init_state()
    mu, nu = adam_moments(opt_state)
    out = {f"param/{k}": v.detach().clone() for k, v in state.params.items()}
    out.update({f"exp_avg/{k}": v.clone() for k, v in mu.items()})
    out.update({f"exp_avg_sq/{k}": v.clone() for k, v in nu.items()})
    for name in ("active", "max_radii2d", "xyz_grad_accum", "denom"):
        out[name] = getattr(state, name).clone()
    out["count"] = opt_state.count
    out["adam_steps"] = [opt_state.state[opt_state.param(k)]["step"].clone()
                         for k in state.params]
    return out


@torch.no_grad()
def restore(state: GaussianState, opt_state, snap: dict):
    """Write :func:`snapshot` ``snap`` back into ``state`` and
    ``opt_state``, every tensor in place."""
    mu, nu = adam_moments(opt_state)
    for k, v in state.params.items():
        v.copy_(snap[f"param/{k}"])
        mu[k].copy_(snap[f"exp_avg/{k}"])
        nu[k].copy_(snap[f"exp_avg_sq/{k}"])
    for name in ("active", "max_radii2d", "xyz_grad_accum", "denom"):
        getattr(state, name).copy_(snap[name])
    opt_state.count = snap["count"]
    for k, t in zip(state.params, snap["adam_steps"]):
        opt_state.state[opt_state.param(k)]["step"] = t.clone()


def snapshot_differences(a: dict, b: dict) -> list:
    """The keys of two :func:`snapshot`s whose values differ, bit for bit."""

    def same(x, y):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                x, y = x.view(torch.int32), y.view(torch.int32)
            return torch.equal(x, y)
        if isinstance(x, list):
            return all(same(u, v) for u, v in zip(x, y))
        return x == y

    return [k for k in a if not same(a[k], b[k])]


@torch.no_grad()
def _rebind(state: GaussianState, new: GaussianState) -> GaussianState:
    """``new`` written into ``state``'s tensors, in place: the optimizer
    stays bound to the parameters, and a captured train step to every
    tensor it reads and writes (capacity is fixed between growths).
    Returns ``state`` with ``new``'s host fields."""
    for k, v in new.params.items():
        state.params[k].copy_(v)
    for name in ("active", "max_radii2d", "xyz_grad_accum", "denom"):
        getattr(state, name).copy_(getattr(new, name))
    return dataclasses.replace(new, params=state.params, active=state.active,
                               max_radii2d=state.max_radii2d,
                               xyz_grad_accum=state.xyz_grad_accum, denom=state.denom)


def make_densify_step(opt, cfg: TrainConfig):
    """The densification and opacity-reset steps (gsjax's
    ``make_densify_step``), over a state and the optimizer bound to its
    parameters:

    ``densify_step(state, opt_state, key, use_screen_size, eps=None) ->
    (state, opt_state, stats)`` and ``opacity_reset_step(state, opt_state)
    -> (state, opt_state)``. ``key`` is the split noise's ``utils.prng``
    key (or ``eps``, see ``models.densify.densify_and_prune``). Every
    tensor of the state and Adam's moments are written in place, so the
    optimizer and a captured train step stay bound to them; the moments
    are zeroed at every written slot, and the optimizer's counts stay."""
    dcfg = DensifyConfig(
        grad_threshold=opt.densify_grad_threshold,
        percent_dense=opt.percent_dense,
    )

    def densify_step(state, opt_state, key, use_screen_size: bool, eps=None):
        mu, nu = adam_moments(opt_state)
        new, mu, nu, stats = densify_and_prune(
            state, mu, nu, key, cfg.extent, dcfg, use_screen_size=use_screen_size, eps=eps)
        return _rebind(state, new), write_adam_moments(opt_state, mu, nu), stats

    def opacity_reset_step(state, opt_state):
        mu, nu = adam_moments(opt_state)
        new, mu, nu = reset_opacity(state, mu, nu, dcfg)
        return _rebind(state, new), write_adam_moments(opt_state, mu, nu)

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
