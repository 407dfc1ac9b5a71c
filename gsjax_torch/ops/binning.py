"""Tile binning: (Gaussian, tile) pair expansion, depth sort, tile ranges.

Counterpart of ``gsjax.ops.binning`` — the replacement for the reference's
duplicateWithKeys -> radix sort -> identifyTileRanges pipeline — with the
same four expansion modes (exact depth sort, compact, untiered grid, tiered
grid), the same packed key and the same counters, so every output is
bit-identical to gsjax's on the same ``Splats``.

Keys. gsjax packs (tile id, top depth bits) into one uint32 and sorts it
with ``lax.sort``, breaking ties by the pair's slot id. torch has only
partial uint32 support, so keys live in int64 here: the uint32 key shifted
left by 31 bits, OR the slot id (a non-negative int32), is one unique int64
whose ascending order is exactly gsjax's (key, slot) order — the shift is
31, not 32, so the top key bit stays below the int64 sign bit.

Depth bits. gsjax takes ``maximum(depth, 0)`` (which maps -0.0 to +0.0)
and shifts the f32 bit pattern *logically*. torch's ``>>`` on a signed
integer is arithmetic and ``clamp_min`` keeps -0.0, so the port adds +0.0
(turning -0.0 into +0.0) and works on the bit pattern widened to int64,
where the shift of a non-negative value is the logical one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gsjax_torch.ops.projection import Splats

_I32 = torch.int32
_I64 = torch.int64


class TileBins(NamedTuple):
    pair_gauss: torch.Tensor  # (P,) int32 ORIGINAL gaussian index per pair
    pair_tile: torch.Tensor  # (P,) int32 tile id per sorted pair (T = sentinel)
    pair_slot: torch.Tensor  # (P,) int32 slot id per pair: (pos * mt + j)
    # for grid layouts, row-major compact pair index for the compact one
    tile_start: torch.Tensor  # (T + 1,) int32 range starts into sorted pairs
    num_pairs: torch.Tensor  # () int32 valid pairs after caps
    num_dropped: torch.Tensor  # () int32 pairs lost to mt / tier / budget caps
    num_mt_capped: torch.Tensor  # () int32 subset lost to per-gaussian caps
    num_tier_capped: torch.Tensor  # () int32 subset lost only to the small tier
    gauss_count: torch.Tensor  # (N,) int32 expanded pairs per gaussian, in
    # SLOT (row) order when partition-sorted, original order otherwise
    gauss_inv_perm: Optional[torch.Tensor]  # (N,) int32 original gaussian
    # i's row position in slot order (None for exact / untiered grid)
    mt: int  # max tiles per gaussian (slot stride in grid layout)


def key_depth_bits(num_tiles: int) -> int:
    """Depth bits of the packed sort key: the tile id (and its sentinel,
    ``num_tiles``) takes the low bits' complement of a uint32."""
    return 32 - max(int(num_tiles + 1).bit_length(), 1)


def _quantized_depth(depths, depth_bits: int):
    """Positive-f32 bit pattern truncated to ``depth_bits`` (int64) —
    monotone in depth, so integer order == depth order."""
    d = torch.clamp_min(depths.to(torch.float32), 0.0) + 0.0  # -0.0 -> +0.0
    bits = d.view(_I32).to(_I64) & 0xFFFFFFFF
    return bits >> (31 - depth_bits)


def _expand_keys(rect_min_x, rect_min_y, rect_w, depth_q, counts, pos0: int,
                 mt_tier: int, mt: int, tiles_x: int, num_tiles: int,
                 depth_bits: int):
    """Dense (rows, mt_tier) key grid for one tier. Returns flat
    (keys int64 holding uint32 values, slots int64)."""
    n = rect_min_x.shape[0]
    dev = rect_min_x.device
    j = torch.arange(mt_tier, dtype=_I64, device=dev)[None, :]
    w = torch.clamp_min(rect_w.to(_I64), 1)[:, None]
    tx = rect_min_x.to(_I64)[:, None] + j % w
    ty = rect_min_y.to(_I64)[:, None] + j // w
    tile = ty * tiles_x + tx
    valid = j < counts.to(_I64)[:, None]
    tile = torch.where(valid, tile, num_tiles)  # sentinel sorts to the end
    dq = torch.where(valid, depth_q[:, None], (1 << depth_bits) - 1)
    key = (tile << depth_bits) | dq
    pos = pos0 + torch.arange(n, dtype=_I64, device=dev)
    slot = pos[:, None] * mt + j
    return key.reshape(-1), slot.reshape(-1)


def _sort_by_key_slot(key, slot, *payload):
    """Ascending (key, slot) order — gsjax's two-key ``lax.sort``, and its
    stable one-key sort over slot-ordered input. (key, slot) pairs are
    unique, or identical in every payload too (the compact path's
    sentinel tail), so the order of the outputs is fully determined."""
    order = torch.sort((key << 31) | slot).indices
    return (key[order], slot[order]) + tuple(p[order] for p in payload)


def _partition_rows(splats: Splats, mt: int, depth_bits: int):
    """Ascending-(tile count, index) row order of the gaussians, with the
    per-row attributes the expansion needs. gsjax sorts a packed unique
    int32 key ``count * n + index`` when ``n * (mt + 1) < 2**31`` and a
    two-key (count, index) sort otherwise; both give this one order, which
    an int64 key reproduces without the overflow case."""
    n = splats.depths.shape[0]
    dev = splats.depths.device
    raw_counts = torch.clamp_max(splats.tiles_touched, mt).to(_I64)
    depth_q = _quantized_depth(splats.depths, depth_bits)
    idx = torch.arange(n, dtype=_I64, device=dev)
    order = torch.sort(raw_counts * n + idx).indices
    rect_w = (splats.rect_max[:, 0] - splats.rect_min[:, 0]).to(_I64)
    return (
        order,  # orig_idx: original gaussian of each row
        splats.rect_min[:, 0].to(_I64)[order],
        splats.rect_min[:, 1].to(_I64)[order],
        rect_w[order],
        depth_q[order],
        raw_counts[order],
    )


def build_tile_bins(
    splats: Splats,
    tiles_x: int,
    tiles_y: int,
    max_pairs: int,
    exact_depth_sort: bool = False,
    max_tiles_per_gauss: int = 32,
    tier_frac: float = 0.0,
    expansion: str = "grid",
    depth_bits: Optional[int] = None,
) -> TileBins:
    """Expand per-Gaussian tile rectangles into sorted (tile, depth) pairs.

    Same modes and outputs as gsjax's ``build_tile_bins``:
    ``exact_depth_sort`` sorts full f32 depths over the dense (N, mt) grid;
    ``expansion="compact"`` expands exactly the budget's pairs after an
    ascending-count partition sort of the gaussians (the rows needing a
    j-th tile form a suffix of that order); ``"grid"`` expands the dense
    (N, mt) grid, optionally *tiered* (``tier_frac`` of the rows at
    ``mt_small = max(2, mt/4)`` slots). Only the leading
    ``min(max_pairs, slots)`` sorted pairs are returned.

    ``depth_bits`` is the width of the quantized depth in the sort key;
    by default all that the tile id leaves of 32 bits
    (:func:`key_depth_bits` of the tile count), as gsjax's (whose
    ``build_tile_bins`` has no such argument) and the sharded path's strips.
    A strip given the frame's width sorts its pairs as the frame does
    (``tests/test_torch_cuda.py`` holds a strip's kernels against the
    frame's tiles so)."""
    n = splats.depths.shape[0]
    dev = splats.depths.device
    mt = max_tiles_per_gauss
    if mt & (mt - 1):
        raise ValueError("max_tiles_per_gauss must be a power of two")
    if expansion not in ("grid", "compact"):
        raise ValueError(f"unknown expansion {expansion!r}")
    num_tiles = tiles_x * tiles_y
    total_desired = torch.sum(splats.tiles_touched.to(_I64))

    if depth_bits is None:
        depth_bits = key_depth_bits(num_tiles)
    elif depth_bits > key_depth_bits(num_tiles):
        raise ValueError(f"{depth_bits} depth bits leave too few for {num_tiles} tiles")

    compact = expansion == "compact" and not exact_depth_sort
    mt_small = max(2, mt // 4)
    ca = min(int(n * tier_frac) // 8 * 8, n)  # small-tier row budget
    tiered = (not exact_depth_sort and not compact and mt_small < mt
              and 0 < ca < n)
    inv_perm = None
    tier_capped = torch.zeros((), dtype=_I64, device=dev)

    if exact_depth_sort:
        counts = torch.clamp_max(splats.tiles_touched, mt).to(_I64)
        j = torch.arange(mt, dtype=_I64, device=dev)[None, :]
        rect_w = torch.clamp_min(
            (splats.rect_max[:, 0] - splats.rect_min[:, 0]).to(_I64), 1
        )[:, None]
        tx = splats.rect_min[:, 0:1].to(_I64) + j % rect_w
        ty = splats.rect_min[:, 1:2].to(_I64) + j // rect_w
        valid = j < counts[:, None]
        tile = torch.where(valid, ty * tiles_x + tx, num_tiles).reshape(-1)
        depth = torch.where(
            valid, splats.depths.to(torch.float32)[:, None], float("inf")
        ).reshape(-1)
        # lexicographic (tile, depth, slot) with slot = flat index: two
        # stable sorts, least significant key first
        order = torch.sort(depth, stable=True).indices
        order = order[torch.sort(tile[order], stable=True).indices]
        tile_s = tile[order]
        sorted_slot = order
        sorted_g = order // mt
        gauss_count = counts
        total_slots = n * mt
    elif compact:
        orig_idx, rx, ry, rw, dq, cnt = _partition_rows(splats, mt, depth_bits)
        # suffix starts: rows with count > j begin at s_j[j] (counts are
        # non-decreasing); off[j] = first compact pair index of slot j
        js = torch.arange(mt + 1, dtype=_I64, device=dev)
        s_j = torch.searchsorted(cnt, js, right=True)
        suffix_len = n - s_j
        off = torch.cat([
            torch.zeros(1, dtype=_I64, device=dev), torch.cumsum(suffix_len[:mt], 0)
        ])
        total = off[mt]  # == sum(cnt)

        p_cap = min(max_pairs, n * mt)
        p_idx = torch.arange(p_cap, dtype=_I64, device=dev)
        # pair -> (slot j, row). gsjax scatter-adds +1 at off[1:] and the
        # base deltas at off[:mt] (mode="drop": an index >= p_cap is
        # dropped, never clamped) and takes cumsums; that is, for every
        # p < p_cap, j_of[p] = #{j in 1..mt : off[j] <= p} and row_base[p]
        # = base[#{j in 0..mt-1 : off[j] <= p} - 1]. The searchsorteds below
        # compute exactly those counts (dropped indices exceed every p).
        j_of = torch.searchsorted(off[1:].contiguous(), p_idx, right=True)
        base = s_j[:mt] - off[:mt]
        row_base = base[torch.searchsorted(off[:mt].contiguous(), p_idx, right=True) - 1]
        valid = p_idx < total
        row = torch.where(valid, row_base + p_idx, 0)

        rowstart = torch.cumsum(cnt, 0) - cnt  # exclusive row-major offsets
        g_rx, g_ry, g_rw = rx[row], ry[row], torch.clamp_min(rw, 1)[row]
        tx = g_rx + j_of % g_rw
        ty = g_ry + j_of // g_rw
        tile = torch.where(valid, ty * tiles_x + tx, num_tiles)
        key = (tile << depth_bits) | torch.where(
            valid, dq[row], (1 << depth_bits) - 1
        )
        # row-major compact slot: always < sum(cnt) <= max_pairs
        slot = rowstart[row] + j_of
        gauss = orig_idx[row]

        key_s, sorted_slot, sorted_g = _sort_by_key_slot(key, slot, gauss)
        tile_s = key_s >> depth_bits
        inv_perm = torch.argsort(orig_idx)
        gauss_count = cnt  # slot (row) order
        total_slots = p_cap
    elif not tiered:
        counts = torch.clamp_max(splats.tiles_touched, mt)
        depth_q = _quantized_depth(splats.depths, depth_bits)
        key, slot = _expand_keys(
            splats.rect_min[:, 0], splats.rect_min[:, 1],
            splats.rect_max[:, 0] - splats.rect_min[:, 0],
            depth_q, counts, 0, mt, mt, tiles_x, num_tiles, depth_bits,
        )
        key_s, sorted_slot = _sort_by_key_slot(key, slot)
        tile_s = key_s >> depth_bits
        sorted_g = sorted_slot // mt
        gauss_count = counts.to(_I64)
        total_slots = n * mt
    else:
        # tier partition: ascending tile count (index-tiebroken), so the big
        # tier holds exactly the n - ca largest footprints
        orig_idx, rx, ry, rw, dq, cnt = _partition_rows(splats, mt, depth_bits)
        cap = torch.where(torch.arange(n, device=dev) < ca, mt_small, mt)
        counts = torch.minimum(cnt, cap)

        key_a, slot_a = _expand_keys(
            rx[:ca], ry[:ca], rw[:ca], dq[:ca], counts[:ca],
            0, mt_small, mt, tiles_x, num_tiles, depth_bits,
        )
        key_b, slot_b = _expand_keys(
            rx[ca:], ry[ca:], rw[ca:], dq[ca:], counts[ca:],
            ca, mt, mt, tiles_x, num_tiles, depth_bits,
        )
        gauss = torch.cat([
            torch.repeat_interleave(orig_idx[:ca], mt_small),
            torch.repeat_interleave(orig_idx[ca:], mt),
        ])
        key_s, sorted_slot, sorted_g = _sort_by_key_slot(
            torch.cat([key_a, key_b]), torch.cat([slot_a, slot_b]), gauss
        )
        tile_s = key_s >> depth_bits
        inv_perm = torch.argsort(orig_idx)
        gauss_count = counts  # slot (row) order
        total_slots = ca * mt_small + (n - ca) * mt
        tier_capped = torch.sum(cnt) - torch.sum(counts)

    # only the leading budget feeds compositing; valid pairs sort first
    p = min(max_pairs, total_slots)
    tile_s = tile_s[:p].to(_I32)
    sorted_slot = sorted_slot[:p].to(_I32)
    sorted_g = sorted_g[:p].to(_I32)

    tile_start = torch.searchsorted(
        tile_s, torch.arange(num_tiles + 1, dtype=_I32, device=dev), right=False
    ).to(_I32)

    counted = torch.sum(gauss_count)
    num_pairs = torch.clamp_max(counted, p)
    return TileBins(
        pair_gauss=sorted_g,
        pair_tile=tile_s,
        pair_slot=sorted_slot,
        tile_start=tile_start,
        num_pairs=num_pairs.to(_I32),
        num_dropped=(total_desired - num_pairs).to(_I32),
        num_mt_capped=(total_desired - counted).to(_I32),
        num_tier_capped=tier_capped.to(_I32),
        gauss_count=gauss_count.to(_I32),
        gauss_inv_perm=None if inv_perm is None else inv_perm.to(_I32),
        mt=mt,
    )


def slot_layout_of(expansion: str, exact_depth_sort: bool = False) -> str:
    """Slot-id layout produced by :func:`build_tile_bins` for a config:
    "rowmajor" (compact expansion: slot = cumsum(counts)[row] + j, always
    < max_pairs) or "grid" (slot = row * mt + j)."""
    if expansion == "compact" and not exact_depth_sort:
        return "rowmajor"
    return "grid"
