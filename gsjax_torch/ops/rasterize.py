"""Public rasterizer API + naive all-pairs oracle (torch).

Counterpart of ``gsjax.ops.rasterize``. :func:`render` is the functional
equivalent of the reference's ``GaussianRasterizer`` call (reference:
gaussian_renderer/__init__.py:18-100): post-activation Gaussian attributes
plus a camera in, the rendered image, per-Gaussian radii (0 = culled) and
the drop counters out. :func:`render_naive` is the O(N x pixels) oracle
with identical semantics, used as ground truth in tests.

Backends (``RasterizeSettings.backend``), with gsjax's names:

=========  ==========  ==================================================
port       gsjax       compositor
=========  ==========  ==================================================
"scan"     "xla"       :func:`~gsjax_torch.ops.composite.composite_tiles`,
                       the chunked torch scan (capped at
                       ``max_splats_per_tile``; differentiable)
"kernel"   "pallas"    the CUDA kernels of
                       :mod:`~gsjax_torch.ops.cuda_composite` (their plain
                       versions on CPU tensors); differentiable
"auto"     "auto"      "kernel" for CUDA tensors, "scan" for CPU tensors
=========  ==========  ==================================================

The kernel backend follows gsjax's custom-VJP split: when grad is enabled
and a blend input requires grad, it takes the differentiable
:func:`~gsjax_torch.ops.cuda_composite.composite` (training forward kernel,
backward kernel and reduction), whose per-pair table follows
``grad_dtype`` and ``grad_reduce`` as gsjax's Pallas backend's does;
otherwise the bookkeeping-free ``composite_infer``, so the render path is
exactly what it was. The scan backend ignores both settings, as gsjax's
"xla" backend does.

Inside a dispatch or frame, :func:`render` marks two layer boundaries of
``utils.profiling``'s clock: ``prep`` (preprocess and binning) and the
compositing, ``composite_fwd`` where gradients flow, else
``composite_infer``.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.data.cameras import RenderCamera
from gsjax_torch.ops.binning import build_tile_bins
from gsjax_torch.ops.composite import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    assemble_image,
    composite_tiles,
)
from gsjax_torch.ops.cuda_composite import (
    GRAD_DTYPES,
    GRAD_REDUCES,
    composite,
    composite_infer,
    pack_gauss_attrs,
)
from gsjax_torch.ops.projection import TILE, num_tiles, preprocess, project_points
from gsjax_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class RasterizeSettings:
    """Shape budgets of the pipeline — the fields and checks of gsjax's
    ``RasterizeSettings``. ``max_pairs`` bounds the (Gaussian, tile)
    duplication buffer (overflow is counted in ``num_dropped``);
    ``max_splats_per_tile`` bounds the scan's per-tile depth.

    ``grad_dtype`` ("float32" | "bfloat16") and ``grad_reduce`` ("sort" |
    "gather") select the kernel backend's per-pair gradient table: float32,
    or bf16 rounded as gsjax's Pallas backward rounds it (half up under
    "sort", to nearest even under "gather"; see
    ``cuda_composite.composite_bwd``); the reduction is the port's own
    either way. ``splat_exchange`` and ``a2a_rows`` pick the sharded
    path's splat exchange (``gsjax_torch.parallel.shard``). The one field
    the port does not read, kept so a settings object maps one to one onto
    gsjax's: ``pallas_chunk`` (the kernels stage fixed batches)."""

    max_pairs: int = 1 << 20
    max_splats_per_tile: int = 1024
    chunk: int = 32
    backend: str = "auto"  # "auto" | "scan" | "kernel" — see module docstring
    pallas_chunk: int = 128
    exact_depth_sort: bool = False  # full-f32 depth keys
    max_tiles_per_gauss: int = 16  # dense pair-grid stride (power of two)
    tier_frac: float = 0.0  # tiered grid binning; 0 = off
    grad_dtype: str = "float32"
    grad_reduce: str = "sort"
    splat_exchange: str = "all_gather"
    a2a_rows: int = 0
    opacity_aware_radius: bool = True
    expansion: str = "grid"  # "grid" | "compact" (see ops/binning.py)

    def __post_init__(self):
        if self.max_splats_per_tile % self.chunk:
            raise ValueError("max_splats_per_tile must be a multiple of chunk")
        if self.backend not in ("auto", "scan", "kernel"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.grad_dtype not in GRAD_DTYPES:
            raise ValueError(f"unknown grad_dtype {self.grad_dtype!r}")
        if self.grad_reduce not in GRAD_REDUCES:
            raise ValueError(f"unknown grad_reduce {self.grad_reduce!r}")
        if self.splat_exchange not in ("all_gather", "a2a"):
            raise ValueError(f"unknown splat_exchange {self.splat_exchange!r}")
        if self.expansion not in ("grid", "compact"):
            raise ValueError(f"unknown expansion {self.expansion!r}")


def render(
    camera: RenderCamera,
    means3d,
    scales,
    quats,
    opacities,
    shs,
    sh_degree: int,
    bg,
    settings: RasterizeSettings = RasterizeSettings(),
    *,
    scale_modifier=1.0,
    colors_precomp=None,
    cov3d_precomp=None,
    active_mask=None,
    means2d_offset=None,
):
    """Tile-based render. Returns a dict: ``render`` (H, W, 3), ``radii``
    (N,) int32, ``visibility_filter`` (N,) bool, ``final_T`` (H, W) and the
    int32 counters ``num_dropped`` (pairs lost to the budgets: 0 in a
    well-sized run), ``num_mt_capped``, ``num_tier_capped`` and
    ``num_tile_capped``."""
    tiles_x, tiles_y = num_tiles(camera.width, camera.height)
    splats = preprocess(
        means3d, scales, quats, opacities, shs, camera, sh_degree,
        scale_modifier=scale_modifier,
        cov3d_precomp=cov3d_precomp,
        colors_precomp=colors_precomp,
        active_mask=active_mask,
        means2d_offset=means2d_offset,
        opacity_aware_radius=settings.opacity_aware_radius,
    )
    bins = build_tile_bins(
        splats, tiles_x, tiles_y, settings.max_pairs,
        exact_depth_sort=settings.exact_depth_sort,
        max_tiles_per_gauss=settings.max_tiles_per_gauss,
        tier_frac=settings.tier_frac,
        expansion=settings.expansion,
    )
    profiling.mark("prep")
    dev = means3d.device
    backend = settings.backend
    if backend == "auto":
        backend = "kernel" if dev.type == "cuda" else "scan"
    blend_in = (splats.means2d, splats.conics, splats.colors, splats.opacities)
    differentiable = torch.is_grad_enabled() and any(t.requires_grad for t in blend_in)
    if backend == "kernel":
        if differentiable:
            tile_colors, tile_T = composite(
                *blend_in, bins.tile_start, bins.pair_gauss, tiles_x, tiles_y,
                settings.grad_dtype, settings.grad_reduce)
        else:
            tile_colors, tile_T = composite_infer(
                bins.tile_start, bins.pair_gauss, pack_gauss_attrs(*blend_in),
                tiles_x, tiles_y,
            )
        num_tile_capped = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        tile_colors, tile_T, num_tile_capped = composite_tiles(
            bins.pair_gauss, bins.tile_start, splats.means2d, splats.conics,
            splats.colors, splats.opacities, tiles_x, tiles_y,
            settings.max_splats_per_tile, settings.chunk,
        )
    profiling.mark("composite_fwd" if differentiable else "composite_infer")
    image, final_T = assemble_image(
        tile_colors, tile_T, torch.as_tensor(bg, dtype=torch.float32, device=dev),
        tiles_x, tiles_y, camera.width, camera.height,
    )
    return {
        "render": image,
        "radii": splats.radii,
        "visibility_filter": splats.radii > 0,
        "final_T": final_T,
        "num_dropped": bins.num_dropped,
        "num_mt_capped": bins.num_mt_capped,
        "num_tier_capped": bins.num_tier_capped,
        "num_tile_capped": num_tile_capped,
    }


def render_naive(
    camera: RenderCamera,
    means3d,
    scales,
    quats,
    opacities,
    shs,
    sh_degree: int,
    bg,
    *,
    scale_modifier=1.0,
    colors_precomp=None,
    cov3d_precomp=None,
    active_mask=None,
    means2d_offset=None,
):
    """All-pairs oracle: every Gaussian against every pixel, depth-sorted.

    Same culling, tile-membership rule and early-exit freeze as the tile
    renderer, with no budgets — O(N * H * W) memory; test scale only."""
    splats = preprocess(
        means3d, scales, quats, opacities, shs, camera, sh_degree,
        scale_modifier=scale_modifier,
        cov3d_precomp=cov3d_precomp,
        colors_precomp=colors_precomp,
        active_mask=active_mask,
        means2d_offset=means2d_offset,
    )
    dev = means3d.device
    h, w = camera.height, camera.width
    order = torch.argsort(splats.depths, stable=True)

    mean = splats.means2d[order]  # (N, 2)
    con = splats.conics[order]
    col = splats.colors[order]
    op = splats.opacities[order]
    rect_min = splats.rect_min[order]
    rect_max = splats.rect_max[order]
    visible = splats.radii[order] > 0

    ys, xs = torch.meshgrid(
        torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij"
    )
    pix = torch.stack([xs, ys], dim=-1).reshape(-1, 2).to(torch.float32)  # (P, 2)
    ptile = torch.div(pix, TILE, rounding_mode="floor").to(torch.int32)

    dx = pix[:, None, 0] - mean[None, :, 0]  # (P, N)
    dy = pix[:, None, 1] - mean[None, :, 1]
    power = (
        -0.5 * (con[None, :, 0] * dx * dx + con[None, :, 2] * dy * dy)
        - con[None, :, 1] * dx * dy
    )
    alpha = torch.clamp_max(op[None, :] * torch.exp(power), ALPHA_MAX)
    in_rect = (
        (ptile[:, None, 0] >= rect_min[None, :, 0])
        & (ptile[:, None, 0] < rect_max[None, :, 0])
        & (ptile[:, None, 1] >= rect_min[None, :, 1])
        & (ptile[:, None, 1] < rect_max[None, :, 1])
    )
    ok = visible[None, :] & in_rect & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))

    cum = torch.cumsum(torch.log1p(-alpha), dim=-1)
    trip = ok & (torch.exp(cum) < T_EPS)
    done = torch.cumsum(trip.to(torch.int32), dim=-1) > 0
    alpha_eff = torch.where(done, torch.zeros_like(alpha), alpha)
    l1m_eff = torch.log1p(-alpha_eff)
    cum_eff = torch.cumsum(l1m_eff, dim=-1)
    weights = torch.exp(cum_eff - l1m_eff) * alpha_eff  # (P, N)
    color = weights @ col  # (P, 3)
    final_T = torch.exp(cum_eff[:, -1])
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    image = color + final_T[:, None] * bg[None, :]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return {
        "render": image.reshape(h, w, 3),
        "radii": splats.radii,
        "visibility_filter": splats.radii > 0,
        "final_T": final_T.reshape(h, w),
        "num_dropped": zero,
        "num_mt_capped": zero,
        "num_tier_capped": zero,
        "num_tile_capped": zero,
    }


def mark_visible(means3d, camera: RenderCamera, near: float = 0.2):
    """Frustum visibility of 3D points — the rasterizer's ``markVisible``
    API. Returns (N,) bool."""
    depth, _ = project_points(means3d.to(torch.float32), camera)
    return depth > near
