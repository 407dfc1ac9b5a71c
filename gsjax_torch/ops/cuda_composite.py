"""CUDA compositing kernels, their plain versions, and their inputs.

Counterpart of ``gsjax.ops.pallas_composite``. It holds:

- :func:`pack_f16_pair` and :func:`pack_gauss_attrs`, the per-gaussian
  half of gsjax's ``pack_pair_attrs``: an (N, 8) float32 table with colors
  and opacity as packed f16 words. The kernels gather their rows through
  ``pair_gauss`` themselves, so the (P, 8) pair table gsjax builds is
  never materialised.
- :func:`pack_bf16_pairs` and :func:`unpack_bf16_pairs`, gsjax's
  ``_pack_bf16_pair_rows`` / ``_unpack_bf16_pair_word`` on a whole
  per-pair gradient table: the (P, 5) int32 table of bf16 pairs that the
  backward writes under ``grad_dtype="bfloat16"``.
- Three wrappers of hand-written CUDA kernels in ``gsjax_torch/csrc/``,
  each with a plain PyTorch version with the same inputs, outputs and
  semantics. Each launches through :func:`gsjax_torch.ops.kernels.launch`,
  which counts it under the wrapper's name in ``utils.profiling``'s
  ``launches()``:

  ========================  ==========================  ==============================
  wrapper                   kernel source               replaces (gsjax Pallas)
  ========================  ==========================  ==============================
  :func:`composite_infer`   ``composite_infer.cu``      ``_composite_infer_kernel``
  :func:`composite_fwd`     ``composite_fwd.cu``        ``_composite_kernel``
  :func:`composite_bwd`     ``composite_bwd.cu``        ``_composite_bwd_kernel``
  ========================  ==========================  ==============================

  :func:`composite_fwd_check` launches the forward kernel's walk without
  its per-warp cull, and :func:`composite_bwd_counts` the backward
  kernel's two check instances, which also write each pixel's count of
  contributing pairs (with and without the per-warp cull); nothing on the
  render or training path calls them. :func:`footprint_box_plain` mirrors
  the kernels' per-warp cull.

- :func:`reduce_pair_grads`, plain torch: per-pair gradients summed to
  per-gaussian ones in a fixed order (the XLA reduction of gsjax's
  ``composite_pallas_grads``), and :func:`composite_grads`, the two
  together.
- :class:`CompositeFunction` / :func:`composite`, the differentiable
  compositor (gsjax's ``_composite_vjp``): ``composite_fwd`` forward,
  ``composite_bwd`` plus the reduction backward. Inside a dispatch, the
  backward marks ``utils.profiling``'s layer boundaries ``loss`` (at its
  entry), ``composite_bwd`` and ``reduce``.

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back.

``RasterizeSettings.grad_dtype`` and ``grad_reduce`` select the backward's
per-pair table as they select gsjax's Pallas output (see
:func:`composite_bwd`): float32, or float32 values rounded to bf16 as
gsjax rounds them — half up under ``"sort"``, to nearest even under
``"gather"`` — and packed in pairs. The reduction unpacks them and sums
in float32, in its own order whatever ``grad_reduce`` says.
"""

from __future__ import annotations

import torch

from gsjax_torch.ops import kernels
from gsjax_torch.ops.composite import ALPHA_MAX, ALPHA_MIN, _tile_pixel_coords, scan_tiles
from gsjax_torch.ops.projection import TILE
from gsjax_torch.utils import profiling

PIX = TILE * TILE
ATTR_W = 8  # float32 words per gaussian row
GRAD_W = 9  # per-pair gradients: mean x/y, conic a/b/c, opacity, r/g/b
PACK_W = 5  # int32 words of a packed bf16 row: (mx, my), (ca, cb), (cc, op), (r, g), (b, 0)
GRAD_DTYPES = ("float32", "bfloat16")
GRAD_REDUCES = ("sort", "gather")
PLAIN_CHUNK = 32  # pairs per round of the plain versions' scans
NWARP = PIX // 32  # warps of a tile's block; warp w holds pixel rows 2w, 2w + 1
# csrc/composite_bwd.cu: pairs staged per batch, pairs per warp reduce-scatter
BWD_BATCH = 64
BWD_GROUP = 8

def pack_f16_pair(hi, lo):
    """Two float32 (N,) tensors -> one float32 tensor whose bits hold
    (f16(hi) << 16) | f16(lo), as gsjax's ``pack_f16_pair``: f16 denormals
    flush to signed zero, values above 65504 become f16 inf."""

    def h16(x):
        h = x.to(torch.float16)
        return torch.where(h.abs() < 2.0 ** -14, torch.copysign(torch.zeros_like(h), h), h)

    # little-endian: the low half of each 32-bit word comes first in memory
    return torch.stack([h16(lo), h16(hi)], dim=-1).view(torch.float32)[..., 0]


def pack_gauss_attrs(means2d, conics, colors, opacities):
    """Per-gaussian (N, 8) float32 rows: mean x/y, conic a/b/c,
    f16(r)<<16|f16(g), f16(b)<<16|f16(opacity), 0 — the per-gaussian half
    of gsjax's ``pack_pair_attrs`` (its last row carries the pair slot,
    which the kernels never read)."""
    return torch.cat(
        [
            means2d.to(torch.float32),
            conics.to(torch.float32),
            pack_f16_pair(colors[:, 0], colors[:, 1])[:, None],
            pack_f16_pair(colors[:, 2], opacities)[:, None],
            torch.zeros_like(means2d[:, :1], dtype=torch.float32),
        ],
        dim=1,
    ).contiguous()


def decode_f16_pair(words):
    """float32 words packed by :func:`pack_f16_pair` -> (hi, lo) float32,
    decoded as the kernels' ``decode_f16`` and gsjax's ``_f16_pair_rows``
    decode them: sign | (em + 112 << 10) << 13 on the 15 exponent and
    mantissa bits em, 0 for em < 1024. An f16 inf reads as 65536."""
    bits = words.contiguous().view(torch.int32)

    def dec(h):
        em = h & 0x7FFF
        f32 = ((h & 0x8000) << 16) | ((em + (112 << 10)) << 13)
        return torch.where(em < 1024, torch.zeros_like(f32), f32).view(torch.float32)

    return dec((bits >> 16) & 0xFFFF), dec(bits & 0xFFFF)


def pack_bf16_pairs(grads, half_up: bool = True):
    """(P, 9) float32 per-pair gradients -> (P, 5) int32: word w holds
    bf16(column 2w) << 16 | bf16(column 2w + 1), a zero tenth column —
    gsjax's ``_pack_bf16_pair_rows`` on the columns in pairs. ``half_up``
    rounds the magnitude half up as gsjax's packed ``grad_reduce="sort"``
    mode does, ``(bits + 0x8000) >> 16`` with int32 wrap-around; else to
    nearest even as its bfloat16 buffer under ``"gather"`` (a NaN as the
    quiet NaN of its sign, as XLA converts it). int32 ops only, on any
    device."""
    bits = torch.cat([grads.to(torch.float32), grads.new_zeros((grads.shape[0], 1),
                                                               dtype=torch.float32)], 1)
    bits = bits.contiguous().view(torch.int32)
    if half_up:
        r = bits + 0x8000
    else:
        r = torch.where(torch.isnan(bits.view(torch.float32)),
                        (bits & -(1 << 31)) | 0x7FC00000, bits + 0x7FFF + ((bits >> 16) & 1))
    return (r[:, 0::2] & -65536) | ((r[:, 1::2] >> 16) & 0xFFFF)


def unpack_bf16_pairs(words):
    """(P, 5) int32 of :func:`pack_bf16_pairs` -> (P, 9) float32, each bf16
    widened exactly (gsjax's ``_unpack_bf16_pair_word``: the high half
    masked, the low half shifted up)."""
    halves = words.contiguous().view(torch.bfloat16).view(words.shape[0], PACK_W, 2)
    # little-endian: the low half of each word comes first in memory
    return halves.flip(-1).reshape(words.shape[0], 2 * PACK_W)[:, :GRAD_W].to(torch.float32)


def _grad_mode(grad_dtype: str, grad_reduce: str) -> int:
    """The backward kernel's output mode: 0 float32, 1 bf16 rounded half up
    (``"sort"``), 2 bf16 rounded to nearest even (``"gather"``)."""
    if grad_dtype not in GRAD_DTYPES:
        raise ValueError(f"grad_dtype must be one of {GRAD_DTYPES}, got {grad_dtype!r}")
    if grad_reduce not in GRAD_REDUCES:
        raise ValueError(f"grad_reduce must be one of {GRAD_REDUCES}, got {grad_reduce!r}")
    if grad_dtype == "float32":
        return 0
    return 1 if grad_reduce == "sort" else 2


def unpack_gauss_attrs(gauss_attrs):
    """(N, 8) table -> (means2d, conics, colors, opacities) in float32; the
    f16 halves decode as in the kernels (:func:`decode_f16_pair`)."""
    r, g = decode_f16_pair(gauss_attrs[:, 5])
    b, opacity = decode_f16_pair(gauss_attrs[:, 6])
    return gauss_attrs[:, 0:2], gauss_attrs[:, 2:5], torch.stack([r, g, b], dim=1), opacity


def _check_inputs(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y):
    num_tiles = tiles_x * tiles_y
    if tile_start.dtype != torch.int32 or tile_start.shape != (num_tiles + 1,):
        raise ValueError(f"tile_start must be int32 ({num_tiles + 1},), got "
                         f"{tile_start.dtype} {tuple(tile_start.shape)}")
    if pair_gauss.dtype != torch.int32 or pair_gauss.dim() != 1:
        raise ValueError("pair_gauss must be a 1-d int32 tensor")
    if (gauss_attrs.dtype != torch.float32 or gauss_attrs.dim() != 2
            or gauss_attrs.shape[1] != ATTR_W):
        raise ValueError(f"gauss_attrs must be float32 (N, {ATTR_W})")
    devs = {tile_start.device, pair_gauss.device, gauss_attrs.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _check_pixel_inputs(num_tiles, dev, d_tile_colors, d_tile_T, final_T, n_contrib):
    want = {"d_tile_colors": (d_tile_colors, torch.float32, (num_tiles, PIX, 3)),
            "d_tile_T": (d_tile_T, torch.float32, (num_tiles, PIX)),
            "final_T": (final_T, torch.float32, (num_tiles, PIX)),
            "n_contrib": (n_contrib, torch.int32, (num_tiles, PIX))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be {dtype} {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _plain_scan(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y, boxes=None):
    """gsjax's chunked scan with no ``max_splats_per_tile`` cap — its
    number of rounds comes from the longest tile in the data, as the
    kernels walk every pair — and, with ``boxes``, the kernels' cull."""
    num_tiles = tiles_x * tiles_y
    longest = int((tile_start[1:] - tile_start[:num_tiles]).max()) if num_tiles else 0
    means2d, conics, colors, opacities = unpack_gauss_attrs(gauss_attrs)
    return scan_tiles(
        pair_gauss, tile_start, means2d, conics, colors, opacities,
        tiles_x, tiles_y, -(-longest // PLAIN_CHUNK), PLAIN_CHUNK, boxes=boxes,
    )


def _launch_blend(name, tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y, with_ncon):
    """Launch the forward blend's C entry ``gsjax_<name>`` on CUDA inputs:
    returns ``(tile_colors, tile_T)``, with ``n_contrib`` if ``with_ncon``."""
    dev = gauss_attrs.device
    num_tiles = tiles_x * tiles_y
    ins = [x.contiguous() for x in (tile_start, pair_gauss, gauss_attrs)]
    outs = [torch.empty((num_tiles, PIX, 3), dtype=torch.float32, device=dev),
            torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)]
    if with_ncon:
        outs.append(torch.empty((num_tiles, PIX), dtype=torch.int32, device=dev))
    kernels.launch(name, *ins, *outs, num_tiles, tiles_x)
    return tuple(outs)


# --------------------------------------------------------------------------
# composite_infer — the render path's forward (no gradient bookkeeping)
# --------------------------------------------------------------------------


def composite_infer_plain(tile_start, pair_gauss, gauss_attrs, tiles_x: int,
                          tiles_y: int, return_evals: bool = False):
    """Plain PyTorch version of the inference kernel: same inputs, same
    outputs ``(tile_colors (T, 256, 3), tile_T (T, 256))``, same
    semantics, up to float reassociation (the scan's cumulative product
    against the kernel's sequential one). With ``return_evals`` it also
    returns the (T, 256) count of (pair, pixel) evaluations the kernel's
    walk needs."""
    _check_inputs(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    tile_colors, tile_T, _, n_eval, _ = _plain_scan(
        tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    if return_evals:
        return tile_colors, tile_T, n_eval
    return tile_colors, tile_T


def composite_infer(tile_start, pair_gauss, gauss_attrs, tiles_x: int, tiles_y: int):
    """Composite every tile's depth-sorted pairs front to back.

    ``tile_start`` (T + 1,) int32 ranges into ``pair_gauss`` (P,) int32,
    which indexes rows of ``gauss_attrs`` (N, 8) float32
    (:func:`pack_gauss_attrs`). Returns ``(tile_colors (T, 256, 3),
    tile_T (T, 256))``. CUDA tensors launch the kernel; CPU tensors take
    :func:`composite_infer_plain`; anything else raises."""
    _check_inputs(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    if gauss_attrs.device.type == "cpu":
        return composite_infer_plain(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    return _launch_blend("composite_infer", tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y,
                         False)


# --------------------------------------------------------------------------
# composite_fwd — the training forward (records n_contrib)
# --------------------------------------------------------------------------


def composite_fwd_plain(tile_start, pair_gauss, gauss_attrs, tiles_x: int, tiles_y: int,
                        boxes=None, return_evals: bool = False):
    """Plain PyTorch version of the training forward kernel: the uncapped
    scan, returning ``(tile_colors (T, 256, 3), tile_T (T, 256),
    n_contrib (T, 256) int32)``. ``boxes`` (N, 4) culls each pair at the
    16x2 strips its box misses, as the kernel does with
    :func:`footprint_box_plain`'s boxes (the scan without them is the
    kernel's check instance). With ``return_evals`` it also returns the
    kernel's warp-level work (:func:`_fwd_warp_stats`)."""
    _check_inputs(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    tile_colors, tile_T, _, n_eval, n_contrib = _plain_scan(
        tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y, boxes)
    if return_evals:
        return tile_colors, tile_T, n_contrib, _fwd_warp_stats(
            tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y, n_eval, n_contrib)
    return tile_colors, tile_T, n_contrib


def _fwd_warp_stats(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y, n_eval, n_contrib):
    """The forward kernels' warp-level work on these inputs, in (pair,
    warp) steps — one warp evaluating one pair for its 32 pixels — from
    the scan's ``n_eval`` and ``n_contrib``:

    - ``steps_exit_bound``: each warp walks its tile's pairs up to its last
      lane's exit, the pair that ends that pixel or the tile's last (the sum
      over warps of the largest ``n_eval``): the walk without the cull;
    - ``steps_walked``: of those, the steps whose pair's box
      (:func:`footprint_box_plain`) meets the warp's 16x2 strip — the
      steps the kernels evaluate after their per-warp cull (a warp whose
      lanes are all done passes over the rest of its 32 staged slots
      without arithmetic);
    - ``steps_blend``: steps in which at least one lane blends;
    - ``evals``: (pair, pixel) evaluations up to each pixel's exit;
    - ``blends``: blended (pair, pixel): a pair passes the tests before
      the pixel's ``n_contrib``, the backward's contributing set."""
    num_tiles = tiles_x * tiles_y
    dev = gauss_attrs.device
    wmax = n_eval.view(num_tiles, NWARP, 32).amax(2)  # (T, 8)
    stats = {"steps_exit_bound": int(wmax.sum()), "steps_walked": 0, "steps_blend": 0,
             "evals": int(n_eval.sum()), "blends": 0}
    n_pairs = pair_gauss.shape[0]
    if num_tiles == 0 or n_pairs == 0:
        return stats
    means2d, conics, colors, opacities = unpack_gauss_attrs(gauss_attrs)
    boxes = footprint_box_plain(means2d, conics, opacities)
    pix = _tile_pixel_coords(tiles_x, tiles_y, dev)
    px, py = pix[:, :, None, 0], pix[:, :, None, 1]
    x0 = pix[:, 0, 0][:, None, None]  # (T, 1, 1): the strips' first column
    y0 = (pix[:, 0, 1][:, None] + 2 * torch.arange(NWARP, device=dev))[..., None]  # (T, 8, 1)
    start = tile_start[:num_tiles].to(torch.int64)
    ncon = n_contrib.to(torch.int64)
    k_local = torch.arange(PLAIN_CHUNK, dtype=torch.int64, device=dev)
    for k in range(-(-int(wmax.max()) // PLAIN_CHUNK)):
        off = k * PLAIN_CHUNK + k_local  # (K,) local pair index
        idx = torch.clamp(start[:, None] + off[None, :], 0, n_pairs - 1)
        g = pair_gauss[idx].to(torch.int64)  # (T, K)
        bx = boxes[g][:, None]  # (T, 1, K, 4)
        walked = ((bx[..., 0] <= x0 + (TILE - 1)) & (bx[..., 1] >= x0)
                  & (bx[..., 2] <= y0 + 1) & (bx[..., 3] >= y0) & (off < wmax[..., None]))
        mean, con, op = means2d[g], conics[g], opacities[g]
        dx = px - mean[:, None, :, 0]  # (T, 256, K)
        dy = py - mean[:, None, :, 1]
        power = (
            -0.5 * (con[:, None, :, 0] * dx * dx + con[:, None, :, 2] * dy * dy)
            - con[:, None, :, 1] * dx * dy
        )
        alpha = torch.clamp_max(op[:, None, :] * torch.exp(power), ALPHA_MAX)
        blend = (off < ncon[..., None]) & (power <= 0.0) & (alpha >= ALPHA_MIN)
        stats["steps_walked"] += int(walked.sum())
        stats["steps_blend"] += int(blend.view(num_tiles, NWARP, 32, PLAIN_CHUNK).any(2).sum())
        stats["blends"] += int(blend.sum())
    return stats


def composite_fwd(tile_start, pair_gauss, gauss_attrs, tiles_x: int, tiles_y: int):
    """:func:`composite_infer` plus ``n_contrib`` (T, 256) int32, the local
    index + 1 of the last pair each pixel blended (0 if none) — what the
    backward replays. Returns ``(tile_colors, tile_T, n_contrib)``. CUDA
    tensors launch the kernel; CPU tensors take :func:`composite_fwd_plain`;
    anything else raises."""
    _check_inputs(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    if gauss_attrs.device.type == "cpu":
        return composite_fwd_plain(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    return _launch_blend("composite_fwd", tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y,
                         True)


def composite_fwd_check(tile_start, pair_gauss, gauss_attrs, tiles_x: int, tiles_y: int):
    """The forward kernel's check instance, never on the render or training
    path: :func:`composite_fwd`'s walk of every pair, without the per-warp
    cull. Returns ``(tile_colors, tile_T, n_contrib)``; :func:`composite_fwd`
    and :func:`composite_infer` must equal it bit for bit — the exact check
    that the cull lost no blend. CUDA tensors launch the kernel (counted as
    ``composite_fwd_check``, apart from ``composite_fwd`` and
    ``composite_infer``); CPU tensors take :func:`composite_fwd_plain`."""
    _check_inputs(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    if gauss_attrs.device.type == "cpu":
        return composite_fwd_plain(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    return _launch_blend("composite_fwd_check", tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y,
                         True)


# --------------------------------------------------------------------------
# composite_bwd — per-pair gradients by back-to-front replay
# --------------------------------------------------------------------------


@torch.no_grad()
def composite_bwd_plain(tile_start, pair_gauss, gauss_attrs, d_tile_colors, d_tile_T,
                        final_T, n_contrib, tiles_x: int, tiles_y: int,
                        return_evals: bool = False, grad_dtype: str = "float32",
                        grad_reduce: str = "sort"):
    """Plain PyTorch version of the backward kernel: the same closed-form
    per-pair gradients (see ``csrc/composite_bwd.cu``), computed chunk by
    chunk of ``PLAIN_CHUNK`` pairs back to front over every tile at once,
    without autograd (a graph through the scan would need tens of GB at
    1080p). Within a chunk, T before each pair is the carried T divided by
    the suffix product of (1 - a), and S the carried S plus the exclusive
    suffix sum — the kernel's sequential replay up to float reassociation.
    Returns the (P, 9) float32 table, or at ``grad_dtype="bfloat16"`` it
    packed by :func:`pack_bf16_pairs` with ``grad_reduce``'s rounding; with
    ``return_evals`` also the (T, 256) count of contributing (pair, pixel)
    evaluations and the kernel's warp-level work (:func:`_bwd_warp_stats`)."""
    _check_inputs(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    mode = _grad_mode(grad_dtype, grad_reduce)
    out, n_live, stats = _bwd_plain_f32(tile_start, pair_gauss, gauss_attrs, d_tile_colors,
                                        d_tile_T, final_T, n_contrib, tiles_x, tiles_y,
                                        return_evals)
    if mode:
        out = pack_bf16_pairs(out, half_up=mode == 1)
    return (out, n_live, stats) if return_evals else out


def _bwd_plain_f32(tile_start, pair_gauss, gauss_attrs, d_tile_colors, d_tile_T, final_T,
                   n_contrib, tiles_x, tiles_y, return_evals):
    """:func:`composite_bwd_plain`'s float32 table, contributing counts and
    (with ``return_evals``) warp-level work."""
    num_tiles = tiles_x * tiles_y
    dev = gauss_attrs.device
    _check_pixel_inputs(num_tiles, dev, d_tile_colors, d_tile_T, final_T, n_contrib)
    n_pairs = pair_gauss.shape[0]
    out = torch.zeros((n_pairs, GRAD_W), dtype=torch.float32, device=dev)
    n_live = torch.zeros((num_tiles, PIX), dtype=torch.int64, device=dev)
    ncon = n_contrib.to(torch.int64)
    maxn = ncon.amax(1) if num_tiles else ncon.new_zeros((0,))  # (T,)
    n_batch = max(1, -(-int(maxn.max()) // BWD_BATCH)) if num_tiles else 1
    # (pair, warp) steps with a contributing lane, per tile, warp and batch
    live_steps = torch.zeros((num_tiles, NWARP, n_batch), dtype=torch.int64, device=dev)
    if num_tiles == 0 or n_pairs == 0:
        return out, n_live, _bwd_warp_stats(ncon, maxn, live_steps, n_live)
    means2d, conics, colors, opacities = unpack_gauss_attrs(gauss_attrs)
    pix = _tile_pixel_coords(tiles_x, tiles_y, dev)
    px, py = pix[:, :, None, 0], pix[:, :, None, 1]
    start = tile_start[:num_tiles].to(torch.int64)
    n_rounds = -(-int(maxn.max()) // PLAIN_CHUNK)
    if return_evals:  # the kernel's per-warp cull: boxes, strips, replay bounds
        boxes = footprint_box_plain(means2d, conics, opacities)
        x0 = pix[:, 0, 0][:, None]  # (T, 1): the strips' first column
        y0 = pix[:, 0, 1][:, None] + 2 * torch.arange(NWARP, device=dev)  # (T, 8)
        wmax = ncon.view(num_tiles, NWARP, 32).amax(2)  # (T, 8)
        steps_walked = 0
    k_local = torch.arange(PLAIN_CHUNK, dtype=torch.int64, device=dev)
    V = d_tile_colors[:, :, None, :]  # (T, 256, 1, 3)
    tn_u = (final_T * d_tile_T)[..., None]
    T_c = final_T.clone()  # T after every pair of the chunks replayed so far
    S = torch.zeros_like(final_T)

    for k in reversed(range(n_rounds)):
        off = k * PLAIN_CHUNK + k_local  # (K,) local pair index
        in_range = off[None, :] < maxn[:, None]  # (T, K)
        idx = torch.clamp(start[:, None] + off[None, :], 0, n_pairs - 1)
        g = pair_gauss[idx].to(torch.int64)
        mean, con, col, op = means2d[g], conics[g], colors[g], opacities[g]
        dx = px - mean[:, None, :, 0]  # (T, 256, K)
        dy = py - mean[:, None, :, 1]
        ca, cb, cc = (con[:, None, :, i] for i in range(3))
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        raw = op[:, None, :] * torch.exp(power)
        alpha = torch.clamp_max(raw, ALPHA_MAX)
        contrib = (in_range[:, None, :] & (off < ncon[..., None])
                   & (power <= 0.0) & (alpha >= ALPHA_MIN))
        a = torch.where(contrib, alpha, torch.zeros_like(alpha))
        one_m = 1.0 - a
        suffix = torch.flip(torch.cumprod(torch.flip(one_m, [-1]), -1), [-1])  # inclusive
        T_i = T_c[..., None] / suffix  # T before each pair
        w = a * T_i
        cdotv = (V * col[:, None, :, :]).sum(-1)
        q = w * cdotv
        S_i = S[..., None] + torch.flip(torch.cumsum(torch.flip(q, [-1]), -1), [-1]) - q
        dalpha = T_i * cdotv - (S_i + tn_u) / one_m
        g_pow = torch.where(contrib & (raw <= ALPHA_MAX), alpha * dalpha,
                            torch.zeros_like(alpha))
        s_dx, s_dy = (dx * g_pow).sum(1), (dy * g_pow).sum(1)  # (T, K)
        rgb = (w[..., None] * V).sum(1)  # (T, K, 3)
        grads = torch.stack([
            con[..., 0] * s_dx + con[..., 1] * s_dy,
            con[..., 2] * s_dy + con[..., 1] * s_dx,
            -0.5 * (dx * dx * g_pow).sum(1),
            -(dx * dy * g_pow).sum(1),
            -0.5 * (dy * dy * g_pow).sum(1),
            g_pow.sum(1) / torch.clamp_min(op, 1e-12),
            rgb[..., 0], rgb[..., 1], rgb[..., 2],
        ], dim=-1)  # (T, K, 9)
        out[idx[in_range]] = grads[in_range]
        n_live += contrib.sum(-1)
        if return_evals:  # the kernel's batches run from maxn down in steps of BWD_BATCH
            batch = torch.div(maxn[:, None] - 1 - off[None, :], BWD_BATCH,
                              rounding_mode="floor").clamp(0, n_batch - 1)
            live_w = contrib.view(num_tiles, NWARP, 32, PLAIN_CHUNK).any(2)
            live_steps.scatter_add_(2, batch[:, None, :].expand(-1, NWARP, -1),
                                    live_w.to(torch.int64))
            bx = boxes[g][:, None]  # (T, 1, K, 4)
            walked = ((bx[..., 0] <= x0[..., None] + (TILE - 1)) & (bx[..., 1] >= x0[..., None])
                      & (bx[..., 2] <= y0[..., None] + 1) & (bx[..., 3] >= y0[..., None])
                      & (off < wmax[..., None]) & in_range[:, None, :])
            steps_walked += int(walked.sum())
        T_c = T_c / suffix[..., 0]
        S = S + q.sum(-1)
    if return_evals:
        return out, n_live, _bwd_warp_stats(ncon, maxn, live_steps, n_live, steps_walked)
    return out, n_live, None


def footprint_box_plain(means2d, conics, opacities):
    """(N, 4) float32 boxes (x lo, x hi, y lo, y hi), each holding every
    pixel its gaussian can contribute to: ``footprint_box`` of
    ``csrc/composite_blend.cuh``, line for line in float32 (see there for the
    bound and its margins). Empty (lo = +inf, hi = -inf) below opacity
    1/255; the full plane when anything is non-finite, the conic is not
    positive definite or the box is wider than 1e5 pixels."""
    mx, my = means2d[:, 0].float(), means2d[:, 1].float()
    a, b, c = (conics[:, i].float() for i in range(3))
    op = opacities.float()
    inf = float("inf")
    finite = (torch.isfinite(mx) & torch.isfinite(my) & torch.isfinite(a) & torch.isfinite(b)
              & torch.isfinite(c) & torch.isfinite(op))
    visible = op >= ALPHA_MIN
    det = a * c - b * b
    pos_def = (a > 0.0) & (c > 0.0) & (det > 0.0)
    tau = torch.clamp_min(torch.log(255.0 * op), 0.0)
    widen = 1.001 + 4e-6 * (a * c / det)
    tau2 = 2.0 * tau * widen + 1e-5
    hx = torch.sqrt(tau2 * c / det) + 1.0
    hy = torch.sqrt(tau2 * a / det) + 1.0
    small = (hx < 1e5) & (hy < 1e5) & (mx.abs() < 1e5) & (my.abs() < 1e5)
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], 1)
    full = torch.tensor([-inf, inf, -inf, inf], device=box.device)
    empty = torch.tensor([inf, -inf, inf, -inf], device=box.device)
    box = torch.where((pos_def & small)[:, None], box, full)
    box = torch.where(visible[:, None], box, empty)
    return torch.where(finite[:, None], box, full)


def _bwd_warp_stats(ncon, maxn, live_steps, n_live, steps_walked=0):
    """The backward kernel's warp-level work on these inputs, in (pair,
    warp) steps — one warp evaluating one pair for its 32 pixels:

    - ``steps_tile_bound``: every warp replays to its tile's largest
      ``n_contrib`` (the sum over tiles of 8 maxn);
    - ``steps_warp_bound``: each warp replays to its own largest (the sum
      over warps of wmax);
    - ``steps_walked``: of those, the steps whose pair's box
      (:func:`footprint_box_plain`) meets the warp's 16x2 strip — the
      steps the kernel walks after its per-warp cull;
    - ``steps_contrib``: steps in which at least one lane contributes;
    - ``reductions``: warp reduce-scatters, each warp filling
      ``BWD_GROUP`` slots with such steps per batch of ``BWD_BATCH``
      pairs, so per (tile, warp, batch) the ceiling of its steps over
      ``BWD_GROUP``;
    - ``contrib``: contributing (pair, pixel) evaluations, the sum of
      ``n_live``;
    - ``maxn``: the (T,) int64 per-tile largest ``n_contrib``."""
    num_tiles = ncon.shape[0]
    wmax = ncon.view(num_tiles, NWARP, 32).amax(2) if num_tiles else ncon.new_zeros((0,))
    return {
        "steps_tile_bound": NWARP * int(maxn.sum()),
        "steps_warp_bound": int(wmax.sum()),
        "steps_walked": steps_walked,
        "steps_contrib": int(live_steps.sum()),
        "reductions": int(torch.div(live_steps + BWD_GROUP - 1, BWD_GROUP,
                                    rounding_mode="floor").sum()),
        "contrib": int(n_live.sum()),
        "maxn": maxn,
    }


def _bwd_table(n_pairs, mode, dev):
    """The kernel's zeroed output table for output mode ``mode``."""
    if mode == 0:
        return torch.zeros((n_pairs, GRAD_W), dtype=torch.float32, device=dev)
    return torch.zeros((n_pairs, PACK_W), dtype=torch.int32, device=dev)


def composite_bwd(tile_start, pair_gauss, gauss_attrs, d_tile_colors, d_tile_T, final_T,
                  n_contrib, tiles_x: int, tiles_y: int, grad_dtype: str = "float32",
                  grad_reduce: str = "sort"):
    """Per-pair gradients of the compositing: row i of the returned table
    holds d(loss)/d(mean x, mean y, conic a, b, c, opacity, r, g, b) of
    sorted pair i's gaussian as blended in its tile; rows of pairs that no
    pixel blends are zero. Inputs: the forward's inputs, the cotangents
    ``d_tile_colors`` (T, 256, 3) and ``d_tile_T`` (T, 256), and the
    forward's ``final_T`` (T, 256) and ``n_contrib`` (T, 256) int32.

    The table is (P, 9) float32 at ``grad_dtype="float32"``; at
    ``"bfloat16"`` the kernel rounds the same float32 values to bf16 and
    packs them (:func:`pack_bf16_pairs`) into a (P, 5) int32 table, half
    up under ``grad_reduce="sort"`` and to nearest even under
    ``"gather"``, as gsjax's ``composite_pallas_grads`` does. Other values
    raise. CUDA tensors launch the kernel (its bf16 instances counted also
    as ``composite_bwd_bf16``); CPU tensors take :func:`composite_bwd_plain`;
    anything else raises."""
    _check_inputs(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    mode = _grad_mode(grad_dtype, grad_reduce)
    dev = gauss_attrs.device
    if dev.type == "cpu":
        return composite_bwd_plain(tile_start, pair_gauss, gauss_attrs, d_tile_colors,
                                   d_tile_T, final_T, n_contrib, tiles_x, tiles_y,
                                   grad_dtype=grad_dtype, grad_reduce=grad_reduce)
    num_tiles = tiles_x * tiles_y
    _check_pixel_inputs(num_tiles, dev, d_tile_colors, d_tile_T, final_T, n_contrib)
    ins = [x.contiguous() for x in (tile_start, pair_gauss, gauss_attrs, d_tile_colors,
                                    d_tile_T, final_T, n_contrib)]
    pair_grads = _bwd_table(pair_gauss.shape[0], mode, dev)
    kernels.launch("composite_bwd", *ins, pair_grads, num_tiles, tiles_x, mode)
    if mode:
        profiling.launched("composite_bwd_bf16")
    return pair_grads


def composite_bwd_counts(tile_start, pair_gauss, gauss_attrs, d_tile_colors, d_tile_T,
                         final_T, n_contrib, tiles_x: int, tiles_y: int, cull: bool = True,
                         grad_dtype: str = "float32", grad_reduce: str = "sort"):
    """The backward kernel's check instances, never on the training path:
    :func:`composite_bwd`'s instance (``cull``) or the same without its
    per-warp cull, each also writing every pixel's count of contributing
    pairs — the exact check that no contribution was lost. Returns
    :func:`composite_bwd`'s table for ``grad_dtype`` and ``grad_reduce``
    and the (T, 256) int32 counts. CUDA tensors launch the kernel (counted
    as ``composite_bwd_counts``, apart from ``composite_bwd``); CPU tensors
    take :func:`composite_bwd_plain` (its ``n_live`` as the counts)."""
    _check_inputs(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    mode = _grad_mode(grad_dtype, grad_reduce)
    dev = gauss_attrs.device
    args = (tile_start, pair_gauss, gauss_attrs, d_tile_colors, d_tile_T, final_T,
            n_contrib, tiles_x, tiles_y)
    if dev.type == "cpu":
        out, n_live, _ = composite_bwd_plain(*args, return_evals=True, grad_dtype=grad_dtype,
                                             grad_reduce=grad_reduce)
        return out, n_live.to(torch.int32)
    num_tiles = tiles_x * tiles_y
    _check_pixel_inputs(num_tiles, dev, d_tile_colors, d_tile_T, final_T, n_contrib)
    ins = [x.contiguous() for x in args[:7]]
    pair_grads = _bwd_table(pair_gauss.shape[0], mode, dev)
    counts = torch.empty((num_tiles, PIX), dtype=torch.int32, device=dev)
    kernels.launch("composite_bwd_counts", *ins, pair_grads, counts, num_tiles, tiles_x,
                   int(bool(cull)), mode)
    return pair_grads, counts


# --------------------------------------------------------------------------
# reduction to gaussians, and the differentiable compositor
# --------------------------------------------------------------------------


def reduce_pair_grads(pair_grads, pair_gauss, tile_start, n_gauss: int):
    """Sum the per-pair gradients of the valid pairs (the first
    ``tile_start[-1]``) into (n_gauss, 9) float32 per-gaussian ones. The
    table is :func:`composite_bwd`'s: (P, 9) float32, or (P, 5) int32 of
    packed bf16 pairs, whose gathered rows are widened to float32
    (:func:`unpack_bf16_pairs`) before the sum, as gsjax sums its bf16
    gradients in float32.

    ``pair_gauss`` holds each pair's original gaussian row, so reducing by
    it needs none of gsjax's slot bookkeeping (``gauss_inv_perm``, the
    ``slow_lo`` overflow path): tiered and compact binning come out right
    by construction, and pairs lost to the budget simply have no row.
    Deterministic on every device: a stable sort by gaussian, then
    ``segment_reduce``, which sums each segment in order (no float
    atomics). Memory O(P * 9 + N * 9).

    The host never waits for the device here, so the reduction can be
    captured in a CUDA graph: every one of the P rows is reduced, row ``p
    >= tile_start[-1]`` into spare segment ``n_gauss + p % n_gauss`` (one
    spare segment would hold every invalid row, and ``segment_reduce``
    sums a segment in one thread: 18.7 ms for bench1080's 187,234), and
    the spare segments are sliced off; the segment lengths come from
    ``searchsorted`` on the sorted keys. The stable sort keeps each valid
    segment's rows in the order they had, so the sums are those of the
    valid rows alone, bit for bit (zero where a gaussian has no valid row,
    all of them when no row is valid)."""
    dev = pair_gauss.device
    n_pairs = pair_gauss.shape[0]
    n_spare = max(n_gauss, 1)
    p = torch.arange(n_pairs, device=dev)
    keys = torch.where(p < tile_start[-1], pair_gauss.to(torch.int64), n_gauss + p % n_spare)
    g, order = torch.sort(keys, stable=True)
    bounds = torch.searchsorted(g, torch.arange(n_gauss + n_spare + 1, device=dev))
    lengths = bounds[1:] - bounds[:-1]
    rows = pair_grads[order]
    if rows.dtype == torch.int32:
        rows = unpack_bf16_pairs(rows)
    return torch.segment_reduce(rows, "sum", lengths=lengths, axis=0, unsafe=True)[:n_gauss]


def composite_grads(tile_start, pair_gauss, gauss_attrs, d_tile_colors, d_tile_T,
                    final_T, n_contrib, tiles_x: int, tiles_y: int,
                    grad_dtype: str = "float32", grad_reduce: str = "sort"):
    """Backward of the compositing to per-gaussian cotangents — the
    counterpart of gsjax's ``composite_pallas_grads``: :func:`composite_bwd`
    (at ``grad_dtype`` / ``grad_reduce``) then :func:`reduce_pair_grads`.
    Returns ``(d_means2d (N, 2), d_conics (N, 3), d_colors (N, 3),
    d_opacities (N,))``."""
    pair_grads = composite_bwd(tile_start, pair_gauss, gauss_attrs, d_tile_colors,
                               d_tile_T, final_T, n_contrib, tiles_x, tiles_y,
                               grad_dtype=grad_dtype, grad_reduce=grad_reduce)
    profiling.mark("composite_bwd")
    per_gauss = reduce_pair_grads(pair_grads, pair_gauss, tile_start, gauss_attrs.shape[0])
    profiling.mark("reduce")
    return per_gauss[:, 0:2], per_gauss[:, 2:5], per_gauss[:, 6:9], per_gauss[:, 5]


class CompositeFunction(torch.autograd.Function):
    """Differentiable compositing (gsjax's ``_composite_vjp``): forward
    through :func:`composite_fwd`, backward through :func:`composite_grads`.
    Inputs ``(means2d, conics, colors, opacities, tile_start, pair_gauss,
    tiles_x, tiles_y, grad_dtype, grad_reduce)``; outputs ``(tile_colors,
    tile_T)``; gradients for the first four."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, tile_start, pair_gauss,
                tiles_x, tiles_y, grad_dtype, grad_reduce):
        _grad_mode(grad_dtype, grad_reduce)  # raise before the forward, not in the backward
        attrs = pack_gauss_attrs(means2d, conics, colors, opacities)
        tile_colors, tile_T, n_contrib = composite_fwd(
            tile_start, pair_gauss, attrs, tiles_x, tiles_y)
        ctx.save_for_backward(tile_start, pair_gauss, attrs, tile_T, n_contrib)
        ctx.tiles = (tiles_x, tiles_y)
        ctx.grad_settings = (grad_dtype, grad_reduce)
        return tile_colors, tile_T

    @staticmethod
    def backward(ctx, d_tile_colors, d_tile_T):
        profiling.mark("loss")  # the loss and its backward down to the tiles end here
        tile_start, pair_gauss, attrs, tile_T, n_contrib = ctx.saved_tensors
        d_means2d, d_conics, d_colors, d_opacities = composite_grads(
            tile_start, pair_gauss, attrs, d_tile_colors, d_tile_T, tile_T, n_contrib,
            *ctx.tiles, *ctx.grad_settings)
        return d_means2d, d_conics, d_colors, d_opacities, *(None,) * 6


def composite(means2d, conics, colors, opacities, tile_start, pair_gauss,
              tiles_x: int, tiles_y: int, grad_dtype: str = "float32",
              grad_reduce: str = "sort"):
    """Differentiable compositing of one frame: ``(tile_colors (T, 256, 3),
    tile_T (T, 256))``, with gradients to the four per-gaussian inputs,
    through the per-pair table that ``grad_dtype`` and ``grad_reduce``
    select (:func:`composite_bwd`)."""
    return CompositeFunction.apply(means2d, conics, colors, opacities, tile_start,
                                   pair_gauss, tiles_x, tiles_y, grad_dtype, grad_reduce)
