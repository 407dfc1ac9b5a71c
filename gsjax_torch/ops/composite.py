"""Front-to-back alpha compositing over 16x16 pixel tiles (torch scan).

Counterpart of ``gsjax.ops.composite``. The reference render kernel walks
each tile's sorted splat list per pixel: ``C += T * alpha * c;
T *= (1 - alpha)``, skipping a splat whose blend would drop T below 1e-4
together with every splat behind it. Here the recurrence is re-associated
through a cumulative product over chunks of K splats, so one chunk against
all 256 pixels of every tile is dense tensor work; chunks are scanned
front to back carrying (T, done) per pixel. The first trip is found on the
unfrozen prefix (identical up to the trip), alphas from there on are
zeroed and the product recomputed — the sequential loop's semantics up to
float reassociation.

:func:`composite_tiles` is the ``"scan"`` backend (with gsjax's
``max_splats_per_tile`` cap); :mod:`gsjax_torch.ops.cuda_composite` holds
the CUDA kernel and its plain version, which runs the same scan uncapped.
"""

from __future__ import annotations

import torch

from gsjax_torch.ops.projection import TILE

ALPHA_MAX = 0.99  # reference clamp: alpha = min(0.99, ...)
ALPHA_MIN = 1.0 / 255.0  # splats fainter than this are skipped
T_EPS = 1e-4  # early-termination transmittance threshold


def _tile_pixel_coords(tiles_x: int, tiles_y: int, device):
    """Pixel coordinates for every tile: (T, TILE*TILE, 2) float32."""
    t = torch.arange(tiles_x * tiles_y, dtype=torch.int64, device=device)
    ty, tx = t // tiles_x, t % tiles_x
    p = torch.arange(TILE * TILE, dtype=torch.int64, device=device)
    py, px = p // TILE, p % TILE
    x = tx[:, None] * TILE + px[None, :]
    y = ty[:, None] * TILE + py[None, :]
    return torch.stack([x, y], dim=-1).to(torch.float32)


def scan_tiles(pair_gauss, tile_start, means2d, conics, colors, opacities,
               tiles_x: int, tiles_y: int, n_rounds: int, chunk: int, boxes=None,
               pixel_origin=(0.0, 0.0)):
    """``n_rounds`` chunks of ``chunk`` pairs per tile, front to back.

    Returns ``(tile_colors (T, 256, 3), tile_T (T, 256), done (T, 256)
    bool, n_eval (T, 256) int64, n_contrib (T, 256) int32)``; ``n_eval``
    counts the pairs a sequential per-pixel loop evaluates (every in-range
    pair up to and including the one that trips the T < 1e-4 exit) — the
    work a kernel that walks the same pairs needs; ``n_contrib`` is the
    local index + 1 of the last pair the pixel blended (``alpha_eff > 0``),
    0 if none — the bound of the backward's replay. ``boxes`` (N, 4) (x lo,
    x hi, y lo, y hi), if given, culls as the CUDA kernels do: a pair is
    skipped at the pixels of each 16x2 strip (pixel rows 2w and 2w + 1)
    that its gaussian's box misses. ``pixel_origin`` (x, y) offsets the
    pixel grid: a strip of tile rows whose ``means2d`` stay in the whole
    image's pixel coordinates (``parallel.shard``)."""
    dev = means2d.device
    num_tiles = tiles_x * tiles_y
    pix = _tile_pixel_coords(tiles_x, tiles_y, dev)  # (T, 256, 2)
    if tuple(pixel_origin) != (0.0, 0.0):
        pix = pix + torch.tensor(pixel_origin, dtype=torch.float32, device=dev)
    px, py = pix[:, :, None, 0], pix[:, :, None, 1]
    if boxes is not None:  # each pixel's strip: first column x0, first row y0
        x0 = pix[:, :1, None, 0]
        row = torch.arange(TILE * TILE, device=dev) // TILE
        y0 = (pix[:, :1, 1] + (row - row % 2))[..., None]
    start = tile_start[:num_tiles].to(torch.int64)
    count = tile_start[1:num_tiles + 1].to(torch.int64) - start
    k_local = torch.arange(chunk, dtype=torch.int64, device=dev)
    n_pairs = pair_gauss.shape[0]

    shape = (num_tiles, TILE * TILE)
    T_carry = torch.ones(shape, dtype=torch.float32, device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    n_eval = torch.zeros(shape, dtype=torch.int64, device=dev)
    n_contrib = torch.zeros(shape, dtype=torch.int64, device=dev)
    acc = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)
    for k in range(n_rounds if n_pairs else 0):
        off = k * chunk + k_local
        in_range = off[None, :] < count[:, None]  # (T, K)
        idx = torch.clamp(start[:, None] + off[None, :], 0, n_pairs - 1)
        g = pair_gauss[idx].to(torch.int64)  # (T, K)
        mean, con = means2d[g], conics[g]
        col, op = colors[g], opacities[g]

        dx = px - mean[:, None, :, 0]  # (T, 256, K)
        dy = py - mean[:, None, :, 1]
        power = (
            -0.5 * (con[:, None, :, 0] * dx * dx + con[:, None, :, 2] * dy * dy)
            - con[:, None, :, 1] * dx * dy
        )
        alpha = torch.clamp_max(op[:, None, :] * torch.exp(power), ALPHA_MAX)
        ok = in_range[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        if boxes is not None:
            bx = boxes[g][:, None]  # (T, 1, K, 4)
            ok &= ((bx[..., 0] <= x0 + (TILE - 1)) & (bx[..., 1] >= x0)
                   & (bx[..., 2] <= y0 + 1) & (bx[..., 3] >= y0))
        alpha = torch.where(ok, alpha, torch.zeros_like(alpha))

        # unfrozen cumulative product locates the early-termination trip
        cp = torch.cumprod(1.0 - alpha, dim=-1)  # inclusive
        trip = ok & (T_carry[..., None] * cp < T_EPS)
        n_trip = torch.cumsum(trip.to(torch.int32), dim=-1)
        done_inc = done[..., None] | (n_trip > 0)
        done_exc = done[..., None] | (n_trip - trip.to(torch.int32) > 0)
        n_eval += (in_range[:, None, :] & ~done_exc).sum(-1)

        # frozen semantics: zero alphas at/after the trip, recompute
        alpha_eff = torch.where(done_inc, torch.zeros_like(alpha), alpha)
        one_m = 1.0 - alpha_eff
        cp_eff = torch.cumprod(one_m, dim=-1)
        w = T_carry[..., None] * (cp_eff / one_m) * alpha_eff  # 1 - a >= 0.01
        # a pair adds to the pixels it blends into and nowhere else: a color
        # that overflowed f16 (inf) makes exactly those pixels inf, as in the
        # kernel, where a dense w @ col would spread 0 * inf = NaN over the
        # whole chunk (gsjax's XLA path does)
        wc = w[..., None] * col[:, None, :, :]
        acc += torch.where(w[..., None] > 0, wc, torch.zeros_like(wc)).sum(-2)
        last = torch.where(alpha_eff > 0, off + 1, 0).amax(-1)
        n_contrib = torch.maximum(n_contrib, last)

        T_carry = T_carry * cp_eff[..., -1]
        done = done_inc[..., -1]
    return acc, T_carry, done, n_eval, n_contrib.to(torch.int32)


def composite_tiles(
    bins_pair_gauss,
    tile_start,
    means2d,
    conics,
    colors,
    opacities,
    tiles_x: int,
    tiles_y: int,
    max_splats_per_tile: int,
    chunk: int = 32,
    pixel_origin=(0.0, 0.0),
):
    """Blend sorted splats into per-tile pixel buffers (the scan backend).
    ``pixel_origin`` (x, y) offsets the pixel grid (see :func:`scan_tiles`).

    Returns ``(tile_colors (T, 256, 3), tile_transmittance (T, 256),
    num_tile_capped ())``: the scan walks exactly
    ``max_splats_per_tile // chunk`` rounds, so a tile deeper than that
    loses its tail — ``num_tile_capped`` counts those lost pairs on tiles
    where some pixel was still accumulating (the kernel has no such cap)."""
    n_rounds = max(max_splats_per_tile // chunk, 1)
    tile_colors, tile_T, done, _, _ = scan_tiles(
        bins_pair_gauss, tile_start, means2d, conics, colors, opacities,
        tiles_x, tiles_y, n_rounds, chunk, pixel_origin=pixel_origin,
    )
    num_tiles = tiles_x * tiles_y
    count = tile_start[1:num_tiles + 1] - tile_start[:num_tiles]
    overflow = torch.clamp_min(count - n_rounds * chunk, 0)
    live = ~torch.all(done, dim=1)  # some pixel still accumulating
    num_tile_capped = torch.sum(torch.where(live, overflow, 0)).to(torch.int32)
    return tile_colors, tile_T, num_tile_capped


def assemble_image(tile_colors, tile_T, bg, tiles_x, tiles_y, width, height):
    """(T, 256, 3) tiles -> (H, W, 3) image with background compositing.

    ``out = C + T * bg`` as in the CUDA render kernel's epilogue."""
    c = tile_colors + tile_T[..., None] * bg[None, None, :]
    c = c.reshape(tiles_y, tiles_x, TILE, TILE, 3)
    c = c.permute(0, 2, 1, 3, 4).reshape(tiles_y * TILE, tiles_x * TILE, 3)
    t = tile_T.reshape(tiles_y, tiles_x, TILE, TILE)
    t = t.permute(0, 2, 1, 3).reshape(tiles_y * TILE, tiles_x * TILE)
    return c[:height, :width], t[:height, :width]
