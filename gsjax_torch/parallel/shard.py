"""Gaussian-sharded, tile-strip-distributed rendering and training (torch).

Counterpart of ``gsjax.parallel.shard``, one process per rank of a
``data`` x ``gauss`` :class:`~gsjax_torch.parallel.mesh.Mesh`:

* **Preprocess is model-parallel**: each rank runs culling / EWA / SH on
  its block of the Gaussian rows (axis ``gauss``).
* **Splat exchange**: the compact screen-space splats (2D mean, conic,
  color, opacity, depth, tile rect) are all-gathered over ``gauss`` — or,
  with ``splat_exchange="a2a"``, routed by an all-to-all only to the ranks
  whose strips they overlap; raw parameters and optimizer state never move.
* **Compositing is tile-parallel**: each rank bins and blends only its
  horizontal *strip* of 16-px tile rows, the tile rectangles re-clipped to
  the strip, so sort and blend work and the pair budget split G ways. The
  kernel backend shifts ``means2d`` up by the strip's origin (gsjax's trick)
  so the CUDA kernels run on the strip unchanged; the scan backend offsets
  its pixel grid (``composite_tiles(pixel_origin=...)``).
* **Loss is computed in place**: L1 partial sums per strip; SSIM on the
  strip extended by a 5-row halo from the neighbouring ranks (zeros at the
  image borders, the zero padding of the whole-image window); the ranks'
  partial losses sum to the loss. Nothing materializes the full image in
  training.
* **Data parallelism**: the ``data`` axis renders one camera per row;
  parameter gradients are averaged across it and densification statistics
  summed (radii: max).

Each rank differentiates its *partial* loss; the all-gather's backward
(``parallel.comm``) sums every strip's gradient into the owning rank's
rows, so each rank gets exactly the gradients of its own Gaussians (a
gradient of the summed, already replicated loss would be G times too
large). Adam is elementwise, so per-rank Adam on the rank's rows is
global Adam.

Not ported: gsjax's ``_attach_lower`` (the AOT ``.lower`` its XLA
``CapacityWarmer`` compiles ahead; the port compiles nothing ahead, as on
the single-device path).
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.data.cameras import RenderCamera, index_render_camera
from gsjax_torch.models.gaussians import GaussianState, activated_params
from gsjax_torch.ops.binning import build_tile_bins
from gsjax_torch.ops.composite import assemble_image, composite_tiles
from gsjax_torch.ops.cuda_composite import composite, composite_infer, pack_gauss_attrs
from gsjax_torch.ops.projection import TILE, Splats, num_tiles, preprocess
from gsjax_torch.ops.rasterize import RasterizeSettings
from gsjax_torch.parallel import comm
from gsjax_torch.parallel.mesh import Mesh
from gsjax_torch.parallel.multihost import host_local_to_global
from gsjax_torch.train.loss import _depthwise_filter, ssim_map
from gsjax_torch.train.optim import adam_count, adam_moments, with_adam_moments
from gsjax_torch.train.step import TrainConfig, _bg_and_images
from gsjax_torch.utils import prng

HALO = 5  # rows of the 11x11 SSIM window beyond a strip's edge
S_MAX = 4  # destination strips a splat may reach through the a2a exchange

COUNTERS = ("num_dropped_pairs", "num_mt_capped_pairs", "num_tier_capped_pairs",
            "num_tile_capped", "num_exchange_dropped")


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# sharding of the state
# ---------------------------------------------------------------------------


def state_pspecs(state: GaussianState) -> dict:
    """Which leaves are row-sharded over ``gauss`` ("gauss") and which are
    replicated (None): every per-Gaussian tensor, and no scalar. The port
    shards by :func:`shard_gaussian_state` and calls this nowhere; it keeps
    ``gsjax.parallel``'s API whole for its users."""
    specs = {f"params.{k}": "gauss" for k in state.params}
    specs.update({k: "gauss" for k in ("active", "max_radii2d", "xyz_grad_accum", "denom")})
    specs["active_sh_degree"] = None
    return specs


def _row_block(x, mesh: Mesh):
    """This rank's contiguous block of rows (capacity divisible by G)."""
    return host_local_to_global(x, mesh.gauss, mesh.g)


@torch.no_grad()
def shard_gaussian_state(state: GaussianState, mesh: Mesh) -> GaussianState:
    """This rank's block of rows of a whole state (on every rank), as fresh
    tensors on the rank's device; scalars are replicated. The capacity must
    be divisible by the ``gauss`` size."""
    def take(x):
        return _row_block(x, mesh).to(mesh.device).clone()

    return dataclasses.replace(
        state,
        params={k: take(v.detach()) for k, v in state.params.items()},
        active=take(state.active), max_radii2d=take(state.max_radii2d),
        xyz_grad_accum=take(state.xyz_grad_accum), denom=take(state.denom),
    )


@torch.no_grad()
def gather_gaussian_state(state: GaussianState, mesh: Mesh) -> GaussianState:
    """The whole state on every rank of this ``gauss`` row, from each
    rank's block (the inverse of :func:`shard_gaussian_state`)."""
    def cat(x):
        return comm.gather_rows(x.detach(), mesh.gauss_group)

    return dataclasses.replace(
        state,
        params={k: cat(v) for k, v in state.params.items()},
        active=cat(state.active), max_radii2d=cat(state.max_radii2d),
        xyz_grad_accum=cat(state.xyz_grad_accum), denom=cat(state.denom),
    )


@torch.no_grad()
def gather_moments(opt, mesh: Mesh):
    """Adam's moments over the whole state (``(mu, nu)`` dicts), gathered
    from every rank's optimizer over its rows."""
    mu, nu = adam_moments(opt)

    def cat(d):
        return {k: comm.gather_rows(v, mesh.gauss_group) for k, v in d.items()}

    return cat(mu), cat(nu)


@torch.no_grad()
def shard_opt_state(tx, local: GaussianState, whole_opt, mesh: Mesh):
    """This rank's optimizer for ``local`` (``tx.init`` over its parameters)
    from an optimizer over the whole state (a fresh one, a loaded
    checkpoint's or one densification edited): this rank's rows of its
    moments, and its step counts."""
    opt = tx.init(local.params)
    opt.count = whole_opt.count
    if not whole_opt.state:  # no step taken yet: nothing to carry
        return opt
    mu, nu = adam_moments(whole_opt)

    def rows(d):
        return {k: _row_block(v, mesh).to(mesh.device) for k, v in d.items()}

    return with_adam_moments(opt, rows(mu), rows(nu), count=adam_count(whole_opt))


# ---------------------------------------------------------------------------
# splat exchange
# ---------------------------------------------------------------------------


def _exchange_splats(splats: Splats, strips_y: int, mesh: Mesh, k_rows: int):
    """Route each visible splat only to the ranks owning the tile strips its
    rect overlaps — an all-to-all instead of an all-gather. A receiver bins
    and blends at most ``gauss * k_rows`` candidates whatever the global
    splat count.

    Compaction is one small stable sort per rank: expand each splat to its
    <= S_MAX destination strips, sort (dst, idx), and slice each dst's
    segment into a fixed (gauss, k_rows) send buffer. Send overflow (a
    segment longer than ``k_rows``, or a splat spanning > S_MAX strips) is
    truncated and counted — the caller surfaces it like the pair budget.

    Returns (received Splats with ``gauss * k_rows`` rows — invalid rows
    have ``tiles_touched == 0`` — and this rank's dropped-send count).
    Gradients flow through the float fields: the gather's backward is an
    index-add into the local rows, the all-to-all's the reverse exchange."""
    n = splats.depths.shape[0]
    g_sz = mesh.gauss
    dev = splats.depths.device
    visible = splats.tiles_touched > 0
    dst_lo = torch.clamp(torch.div(splats.rect_min[:, 1], strips_y, rounding_mode="floor"),
                         0, g_sz - 1)
    dst_hi = torch.clamp(torch.div(splats.rect_max[:, 1] - 1, strips_y, rounding_mode="floor"),
                         0, g_sz - 1)
    n_dst = torch.where(visible, dst_hi - dst_lo + 1, 0)
    over_span = torch.clamp_min(n_dst - S_MAX, 0).sum()
    n_dst = torch.clamp_max(n_dst, S_MAX)

    j = torch.arange(S_MAX, dtype=torch.int32, device=dev)[None, :]
    dst = dst_lo[:, None] + j  # (n, S_MAX)
    valid = j < n_dst[:, None]
    key = torch.where(valid, dst, g_sz).to(torch.int32).reshape(-1)
    idx = torch.arange(n, dtype=torch.int64, device=dev)[:, None].expand(n, S_MAX).reshape(-1)
    key_s, order = torch.sort(key, stable=True)
    idx_s = idx[order]
    seg = torch.searchsorted(key_s, torch.arange(g_sz + 1, dtype=torch.int32, device=dev),
                             side="left")  # (g_sz + 1,) segment bounds per dst

    kk = torch.arange(k_rows, dtype=torch.int64, device=dev)[None, :]
    pos = seg[:g_sz, None] + kk  # (g_sz, k_rows)
    valid_out = (pos < seg[1:, None]).reshape(-1)
    rows = idx_s[torch.clamp(pos.reshape(-1), 0, n * S_MAX - 1)]
    seg_len = seg[1:] - seg[:-1]
    dropped = (over_span + torch.clamp_min(seg_len - k_rows, 0).sum()).to(torch.int32)

    f32 = torch.cat([splats.means2d, splats.conics, splats.colors,
                     splats.opacities[:, None], splats.depths[:, None]], dim=1)  # (n, 10)
    i32 = torch.cat([splats.rect_min, splats.rect_max], dim=1)
    send_f = torch.where(valid_out[:, None], f32[rows], torch.zeros((), device=dev))
    send_i = torch.where(valid_out[:, None], i32[rows], 0)
    send_i = torch.cat([send_i, valid_out.to(torch.int32)[:, None]], dim=1)
    recv_f = comm.all_to_all(send_f, mesh.gauss_group)
    recv_i = comm.all_to_all_rows(send_i, mesh.gauss_group)
    received = Splats(
        means2d=recv_f[:, 0:2], depths=recv_f[:, 9], conics=recv_f[:, 2:5],
        colors=recv_f[:, 5:8], opacities=recv_f[:, 8],
        radii=recv_i[:, 4],  # not meaningful after the exchange; stats use local radii
        rect_min=recv_i[:, 0:2], rect_max=recv_i[:, 2:4], tiles_touched=recv_i[:, 4],
    )
    return received, dropped


def _gather_splats(splats: Splats, mesh: Mesh) -> Splats:
    """Every rank's splats, concatenated in rank order: the float fields
    through one differentiable all-gather, the integer ones through one
    plain all-gather (radii stay local: the statistics read this rank's)."""
    f32 = torch.cat([splats.means2d, splats.conics, splats.colors,
                     splats.opacities[:, None], splats.depths[:, None]], dim=1)
    i32 = torch.cat([splats.rect_min, splats.rect_max, splats.tiles_touched[:, None]], dim=1)
    f = comm.all_gather(f32, mesh.gauss_group)
    i = comm.gather_rows(i32, mesh.gauss_group)
    return Splats(means2d=f[:, 0:2], depths=f[:, 9], conics=f[:, 2:5], colors=f[:, 5:8],
                  opacities=f[:, 8], radii=i[:, 4], rect_min=i[:, 0:2], rect_max=i[:, 2:4],
                  tiles_touched=i[:, 4])


def strip_splats(splats: Splats, y0: int, strips_y: int) -> Splats:
    """``splats`` with their tile rects clipped to the strip of tile rows
    [y0, y0 + strips_y), in strip-local tile rows, and their tile counts to
    match (``means2d`` stay in the whole image's pixel coordinates)."""
    rmin_y = torch.clamp(splats.rect_min[:, 1] - y0, 0, strips_y)
    rmax_y = torch.clamp(splats.rect_max[:, 1] - y0, 0, strips_y)
    w = splats.rect_max[:, 0] - splats.rect_min[:, 0]
    return splats._replace(
        rect_min=torch.stack([splats.rect_min[:, 0], rmin_y], dim=1),
        rect_max=torch.stack([splats.rect_max[:, 0], rmax_y], dim=1),
        tiles_touched=torch.where(splats.tiles_touched > 0, w * (rmax_y - rmin_y), 0),
    )


def bin_strip(alls: Splats, y0: int, strips_y: int, tiles_x: int,
              settings: RasterizeSettings, gauss: int):
    """Bin the tile strip of rows [y0, y0 + strips_y) from every rank's
    splats ``alls``, as gsjax's ``_render_strip`` bins it
    (gsjax/parallel/shard.py:228-244): the rects clipped to the strip, a
    ``max_pairs // gauss`` budget (at least 1024), no ``exact_depth_sort``
    whatever the settings say, and the depth keyed with what the strip's
    own tile count leaves of the key (finer than the whole frame's: 20
    bits against 19 at 1080p over two strips)."""
    return build_tile_bins(
        strip_splats(alls, y0, strips_y), tiles_x, strips_y,
        max(settings.max_pairs // gauss, 1024),
        max_tiles_per_gauss=settings.max_tiles_per_gauss,
        tier_frac=settings.tier_frac, expansion=settings.expansion,
    )


def _a2a_rows_auto(n_local: int, gauss_size: int, a2a_rows: int) -> int:
    """4x the uniform per-destination share, 128-aligned, unless pinned."""
    if a2a_rows:
        return a2a_rows
    return max(128, _cdiv(4 * n_local, gauss_size * 128) * 128)


# ---------------------------------------------------------------------------
# strip renderer
# ---------------------------------------------------------------------------


def _strip_bins(params_shard, active_shard, sh_degree: int, camera: RenderCamera,
                offset_shard, settings: RasterizeSettings, strips_y: int, mesh: Mesh):
    """Preprocess this rank's rows, exchange the splats and bin this rank's
    tile strip. Returns (local splats, received splats, bins, strip origin
    in tile rows, num_exchange_dropped)."""
    tiles_x, tiles_y = num_tiles(camera.width, camera.height)
    means3d, scales, quats, opac, shs = activated_params(params_shard)
    splats = preprocess(means3d, scales, quats, opac, shs, camera, sh_degree,
                        active_mask=active_shard, means2d_offset=offset_shard,
                        opacity_aware_radius=settings.opacity_aware_radius)
    if settings.splat_exchange == "a2a":
        k_rows = _a2a_rows_auto(splats.depths.shape[0], mesh.gauss, settings.a2a_rows)
        alls, exch_dropped = _exchange_splats(splats, strips_y, mesh, k_rows)
    else:
        alls = _gather_splats(splats, mesh)
        exch_dropped = torch.zeros((), dtype=torch.int32, device=means3d.device)

    y0 = mesh.g * strips_y
    bins = bin_strip(alls, y0, strips_y, tiles_x, settings, mesh.gauss)
    return splats, alls, bins, y0, exch_dropped


def _kernel_blend_inputs(alls: Splats, y0: int):
    """The kernels derive pixel coordinates from the strip-local tile
    index; moving mean_y up by the strip's origin is the same as global
    pixel coordinates (dx, dy unchanged) and needs no kernel change. A
    constant shift leaves d_means2d as it is."""
    shift = torch.tensor([0.0, float(y0 * TILE)], dtype=torch.float32,
                         device=alls.means2d.device)
    return alls.means2d - shift, alls.conics, alls.colors, alls.opacities


@torch.no_grad()
def strip_kernel_args(state: GaussianState, camera: RenderCamera,
                      settings: RasterizeSettings, mesh: Mesh):
    """``(tile_start, pair_gauss, attrs, tiles_x, strips_y)``: what the
    strip path hands ``composite_infer`` / ``composite_fwd`` /
    ``composite_bwd`` on this rank, to hold the kernels against their plain
    versions at the strip's shapes."""
    tiles_x, tiles_y = num_tiles(camera.width, camera.height)
    strips_y = _cdiv(tiles_y, mesh.gauss)
    _, alls, bins, y0, _ = _strip_bins(state.params, state.active, state.active_sh_degree,
                                       camera, None, settings, strips_y, mesh)
    return (bins.tile_start, bins.pair_gauss, pack_gauss_attrs(*_kernel_blend_inputs(alls, y0)),
            tiles_x, strips_y)


def _render_strip(params_shard, active_shard, sh_degree: int, camera: RenderCamera,
                  offset_shard, bg, settings: RasterizeSettings, strips_y: int, mesh: Mesh):
    """Render this rank's tile strip from all ranks' splats.

    Returns (strip_image (strips_y*16, W, 3), strip_T, radii of the local
    rows, num_dropped, num_mt_capped, num_tier_capped, num_tile_capped,
    num_exchange_dropped). The strip starts at tile row ``g * strips_y``."""
    tiles_x = num_tiles(camera.width, camera.height)[0]
    splats, alls, bins, y0, exch_dropped = _strip_bins(
        params_shard, active_shard, sh_degree, camera, offset_shard, settings, strips_y, mesh)
    strip_img, strip_T, tile_capped = blend_strip(alls, bins, y0, strips_y, tiles_x,
                                                  camera.width, bg, settings)
    return (strip_img, strip_T, splats.radii, bins.num_dropped, bins.num_mt_capped,
            bins.num_tier_capped, tile_capped, exch_dropped)


def blend_strip(alls: Splats, bins, y0: int, strips_y: int, tiles_x: int, width: int, bg,
                settings: RasterizeSettings):
    """Blend the strip of tile rows [y0, y0 + strips_y) from its ``bins``
    (:func:`bin_strip`) over the splats ``alls``: (strip_image
    (strips_y*16, width, 3), strip_T, num_tile_capped)."""
    dev = alls.means2d.device
    backend = settings.backend
    if backend == "auto":
        backend = "kernel" if dev.type == "cuda" else "scan"
    if backend == "kernel":
        blend_in = _kernel_blend_inputs(alls, y0)
        if torch.is_grad_enabled() and any(t.requires_grad for t in blend_in):
            tile_colors, tile_T = composite(*blend_in, bins.tile_start, bins.pair_gauss,
                                            tiles_x, strips_y, settings.grad_dtype,
                                            settings.grad_reduce)
        else:
            tile_colors, tile_T = composite_infer(bins.tile_start, bins.pair_gauss,
                                                  pack_gauss_attrs(*blend_in), tiles_x,
                                                  strips_y)
        tile_capped = torch.zeros((), dtype=torch.int32, device=dev)  # the kernels never cap
    else:
        tile_colors, tile_T, tile_capped = composite_tiles(
            bins.pair_gauss, bins.tile_start, alls.means2d, alls.conics, alls.colors,
            alls.opacities, tiles_x, strips_y, settings.max_splats_per_tile, settings.chunk,
            pixel_origin=(0.0, float(y0 * TILE)),
        )
    strip_img, strip_T = assemble_image(tile_colors, tile_T, bg, tiles_x, strips_y, width,
                                        strips_y * TILE)
    return strip_img, strip_T, tile_capped


# ---------------------------------------------------------------------------
# strip losses (partial sums + halo-exchanged SSIM)
# ---------------------------------------------------------------------------


def _ssim_partial_sum(img_strip, gt_strip, row_valid, mesh: Mesh):
    """Sum of the SSIM map over this strip's valid pixels (11x11 window,
    sigma 1.5, the semantics of ``train.loss.ssim``)."""
    x = img_strip * row_valid[:, None, None]
    y = gt_strip * row_valid[:, None, None]
    # HALO rows of the previous / next rank attached; zeros at the image's
    # borders, the zero padding a whole-image 'same' filter sees there
    xe = comm.halo_rows(x, HALO, mesh.gauss_group).permute(2, 0, 1)  # (3, rows + 2 halo, W)
    ye = comm.halo_rows(y, HALO, mesh.gauss_group).permute(2, 0, 1)
    stacked = torch.cat([xe, ye, xe * xe, ye * ye, xe * ye], dim=0)  # (15, rows + 2 halo, W)
    # 'same' filtering of the extended strip, cropped back to the strip:
    # row j + HALO is the window centred at strip row j
    smap = ssim_map(_depthwise_filter(stacked, 11, 1.5)[:, HALO:-HALO, :])
    return torch.sum(smap * row_valid[None, :, None])


# ---------------------------------------------------------------------------
# public builders
# ---------------------------------------------------------------------------


def make_sharded_render(mesh: Mesh, settings: RasterizeSettings, width: int, height: int,
                        with_stats: bool = False):
    """Gaussian-sharded renderer: ``render_fn(state_shard, camera, bg) ->
    (image (H, W, 3), final_T (H, W))`` on every rank of the ``gauss`` row
    (each renders its strip; the strips are gathered). ``with_stats=True``
    appends the pairs dropped over all strips. The ``data`` axis (if > 1)
    replicates."""
    tiles_x, tiles_y = num_tiles(width, height)
    strips_y = _cdiv(tiles_y, mesh.gauss)

    @torch.no_grad()
    def render_fn(state: GaussianState, camera: RenderCamera, bg):
        bg = torch.as_tensor(bg, dtype=torch.float32, device=state.device)
        strip, strip_T, _, dropped, *_ = _render_strip(
            state.params, state.active, state.active_sh_degree, camera, None, bg,
            settings, strips_y, mesh)
        img = comm.gather_rows(strip, mesh.gauss_group)[:height]
        img_T = comm.gather_rows(strip_T, mesh.gauss_group)[:height]
        if with_stats:
            return img, img_T, comm.psum(dropped, mesh.gauss_group)
        return img, img_T

    return render_fn


def make_sharded_train_step(tx, mesh: Mesh, cameras, images, cfg: TrainConfig):
    """The sharded train step.

    ``step(state_shard, opt_state, cam_idx (data,), key=None) ->
    (state_shard, opt_state, metrics)``, the metrics 0-d tensors, the same
    on every rank. Each ``data`` row trains on its own camera
    ``cam_idx[d]``; Gaussians and tile strips shard over ``gauss``. With
    ``random_background``, row ``d``'s background is gsjax's
    ``uniform(split(key, data)[d], (3,))``.
    ``cameras`` and ``images`` (every view) are on every rank;
    ``opt_state`` is ``tx.init`` over the shard's parameters."""
    width, height = cameras[0].width, cameras[0].height
    tiles_x, tiles_y = num_tiles(width, height)
    strips_y = _cdiv(tiles_y, mesh.gauss)
    strip_px = strips_y * TILE
    settings = cfg.settings
    bg_color, images = _bg_and_images(cameras, images, cfg)
    dev = bg_color.device
    n_pix = height * width * 3
    lam = cfg.lambda_dssim
    row0 = mesh.g * strip_px
    row_valid = ((row0 + torch.arange(strip_px, device=dev)) < height).to(torch.float32)
    D = mesh.data
    ndc_scale = torch.tensor([width / 2.0, height / 2.0], dtype=torch.float32, device=dev)

    def step(state: GaussianState, opt_state, cam_idx, key=None):
        params = state.params
        if any(opt_state.param(k) is not v for k, v in params.items()):
            raise ValueError("opt_state is not bound to state.params")
        cam_i = int(cam_idx[mesh.d])
        camera = index_render_camera(cameras, cam_i)
        gt = images[cam_i]
        if gt.dtype == torch.uint8:
            gt = gt.to(torch.float32) / 255.0
        if cfg.random_background:
            if key is None:
                raise ValueError("random_background needs a key")
            bg = prng.uniform(prng.split(key, D)[mesh.d], (3,), dev)
        else:
            bg = bg_color
        gt_strip = torch.zeros((strip_px, width, 3), dtype=torch.float32, device=dev)
        n_rows = max(0, min(height - row0, strip_px))
        gt_strip[:n_rows] = gt[row0:row0 + n_rows]
        offset = torch.zeros((state.capacity, 2), dtype=torch.float32, device=dev,
                             requires_grad=True)

        with torch.enable_grad():
            (strip, _, radii, dropped, capped, tier_capped, tile_capped,
             exch_dropped) = _render_strip(params, state.active, state.active_sh_degree,
                                           camera, offset, bg, settings, strips_y, mesh)
            rv = row_valid[:, None, None]
            strip = strip * rv
            l1_sum = torch.sum(torch.abs(strip - gt_strip) * rv)
            ssim_sum = _ssim_partial_sum(strip, gt_strip, row_valid, mesh)
            # this rank's part of loss = (1-lam) L1 + lam (1 - SSIM):
            # loss = sum over the strips of partial, + lam. gsjax's
            # ((1-lam) l1_sum - lam ssim_sum) / n_pix, associated so that
            # each pixel's gradient is the single-device loss's to the bit
            # ((1-lam) / n_pix and -lam / n_pix, as the means' backward)
            partial = (1.0 - lam) * (l1_sum / n_pix) - lam * (ssim_sum / n_pix)
        opt_state.zero_grad(set_to_none=True)
        partial.backward()

        # the camera batch: gradients averaged, statistics summed, in one
        # reduction over the data axis
        grads = [v.grad if v.grad is not None else torch.zeros_like(v)
                 for v in params.values()]
        g_offset = offset.grad if offset.grad is not None else torch.zeros_like(offset)
        # densification statistics of this camera (models.densify.
        # add_densification_stats): the screen-space gradient in NDC units
        visible = radii > 0
        norms = torch.linalg.vector_norm(g_offset * ndc_scale, dim=-1)
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [torch.where(visible, norms, 0.0), visible.to(torch.float32)])
        flat = comm.psum(flat, mesh.data_group)
        pos = 0
        for v, g in zip(params.values(), grads):
            v.grad = flat[pos:pos + g.numel()].reshape(g.shape) / D
            pos += g.numel()
        n = state.capacity
        norm_inc, denom_inc = flat[pos:pos + n], flat[pos + n:pos + 2 * n]
        radii_max = comm.pmax(radii, mesh.data_group)
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)

        # scalars: psum over gauss, mean over data = the world's sum / D
        # (group None: every rank)
        sums = comm.psum(torch.stack([partial.detach(), l1_sum.detach()]), None)
        counts = comm.psum(torch.stack([dropped, capped, tier_capped, tile_capped,
                                        exch_dropped, state.num_active]).to(torch.int64),
                           None)
        visible = radii_max > 0
        new_state = dataclasses.replace(
            state,
            max_radii2d=torch.where(visible, torch.maximum(state.max_radii2d,
                                                           radii_max.to(torch.float32)),
                                    state.max_radii2d),
            xyz_grad_accum=state.xyz_grad_accum + norm_inc,
            denom=state.denom + denom_inc,
        )
        metrics = {"loss": sums[0] / D + lam, "l1": sums[1] / (D * n_pix)}
        for k, c in zip(COUNTERS, counts[:5]):
            metrics[k] = c.to(torch.int32)
        metrics["num_active"] = (counts[5] // D).to(torch.int32)
        return new_state, opt_state, metrics

    return step


def make_sharded_train_step_chained(tx, mesh: Mesh, cameras, images, cfg: TrainConfig,
                                    n_steps: int):
    """``n_steps`` sharded train steps in one call.

    ``step(state_shard, opt_state, cam_idxs (n_steps, data), key=None) ->
    (state_shard, opt_state, last-step metrics + "loss_mean")``, the
    counters reduced over the steps as gsjax does; step ``i`` takes the key
    ``fold_in(key, i)``."""
    impl = make_sharded_train_step(tx, mesh, cameras, images, cfg)

    def chained(state, opt_state, cam_idxs, key=None):
        ms = []
        for i in range(n_steps):
            k = None if key is None else prng.fold_in(key, i)
            state, opt_state, m = impl(state, opt_state, cam_idxs[i], k)
            ms.append(m)
        stacked = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        metrics = {k: v[-1] for k, v in stacked.items()}
        metrics["loss_mean"] = stacked["loss"].mean()
        for k in COUNTERS:
            metrics[k] = stacked[k].max()
        metrics["num_budget_dropped"] = (
            stacked["num_dropped_pairs"] - stacked["num_mt_capped_pairs"]).max()
        metrics["num_mt_only_capped"] = (
            stacked["num_mt_capped_pairs"] - stacked["num_tier_capped_pairs"]).max()
        return state, opt_state, metrics

    return chained
