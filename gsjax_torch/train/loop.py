"""Budget sizing of the rasterizer (the budget functions of ``gsjax.train.loop``).

The training driver itself comes with the training slice. What is here
sizes ``RasterizeSettings`` for a scene before it renders: a heuristic from
the image size and capacity, then a preprocess probe on the model that
measures its real footprints.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gsjax_torch.models.gaussians import activated
from gsjax_torch.ops.projection import num_tiles, preprocess
from gsjax_torch.ops.rasterize import RasterizeSettings

# small-tier cap candidates for the tier_frac safety check
_TIER_KS = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def default_rasterize_settings(
    width: int, height: int, capacity: int
) -> RasterizeSettings:
    """Heuristic budgets scaled to the scene / render size (gsjax's)."""
    tiles = -(-width // 16) * -(-height // 16)
    max_pairs = min(1 << 24, max(1 << 18, 2 ** int(np.ceil(np.log2(capacity * 4)))))
    mspt = 2048 if tiles > 1024 else 1024
    mt = int(min(128, max(16, 2 ** int(np.ceil(np.log2(max(max_pairs // max(capacity, 1), 1)))))))
    mt = min(mt, 2 ** int(np.ceil(np.log2(tiles))))
    return RasterizeSettings(
        max_pairs=max_pairs, max_splats_per_tile=mspt, chunk=32,
        max_tiles_per_gauss=mt, tier_frac=0.875, grad_dtype="bfloat16",
    )


@torch.no_grad()
def _probe_initial_budgets(settings, state, train_cams, width, height):
    """Measure the model's footprints on up to four cameras and size the
    per-gaussian tile cap, the pair budget, ``tier_frac`` and the
    expansion before the first render — gsjax's probe with
    ``inference=True``, same decisions (its training variant, which grows
    the budget for densification, comes with the training slice)."""
    tiles_x, tiles_y = num_tiles(width, height)
    means3d, scales, quats, opac, shs = activated(state)

    probe_cams = train_cams[:: max(1, len(train_cams) // 4)][:4]
    mt_need, pairs_need = 0, 0
    frac_le_min = np.ones(len(_TIER_KS))
    for c in probe_cams:
        rc = c.to_render_camera(device=state.device)
        if (rc.width, rc.height) != (width, height):
            continue
        counts = preprocess(
            means3d, scales, quats, opac, shs, rc, state.active_sh_degree,
            active_mask=state.active,
            opacity_aware_radius=settings.opacity_aware_radius,
        ).tiles_touched
        frac_le = torch.stack(
            [(counts <= k).to(torch.float32).mean() for k in _TIER_KS]
        )
        mt_need = max(mt_need, int(counts.max()))
        pairs_need = max(pairs_need, int(counts.to(torch.int64).sum()))
        frac_le_min = np.minimum(frac_le_min, frac_le.cpu().numpy())
    if mt_need == 0:
        return settings
    mt = int(
        min(
            2 ** int(np.ceil(np.log2(max(mt_need, 1)))),
            2 ** int(np.ceil(np.log2(tiles_x * tiles_y))),
        )
    )
    # no densification at render time: footprints are fixed and the probe
    # saw the real view-dependent max, so 1.5x headroom suffices (64k-
    # aligned). Inference never reacts to overflow, so a scene needing more
    # than 1<<26 pairs is refused rather than darkened.
    max_pairs = max(1 << 18, -(-int(pairs_need * 1.5) // 65536) * 65536)
    if max_pairs > 1 << 26:
        raise ValueError(
            f"inference pair budget: probe needs {pairs_need} pairs "
            f"({max_pairs} with headroom), above the 1<<26 bound — the "
            "scene cannot render drop-free at this resolution"
        )
    # tier_frac safety: the small tier holds the tier_frac*N smallest
    # footprints at mt/4 slots each; start at the measured fraction of
    # gaussians that fit it (3% margin, min over probe cameras)
    mt_final = max(mt, settings.max_tiles_per_gauss)
    tier_frac = settings.tier_frac
    if tier_frac > 0:
        mt_small = max(2, mt_final // 4)
        if mt_small <= _TIER_KS[-1]:
            ki = min(i for i, k in enumerate(_TIER_KS) if k >= mt_small)
            safe = max(0.0, float(frac_le_min[ki]) - 0.03)
            tier_frac = min(tier_frac, np.floor(safe * 16) / 16)
            if tier_frac < 0.25:  # too small a tier saves no sort time
                tier_frac = 0.0
        else:
            tier_frac = 0.0
    # the dense grid pays ~capacity * mt_mix sort slots; when footprint
    # variance forces a big mt that explodes past the real pair count —
    # switch to the budget-sized compact expansion
    expansion = settings.expansion
    cap = state.capacity
    ca = min(int(cap * tier_frac) // 8 * 8, cap)
    grid_slots = ca * max(2, mt_final // 4) + (cap - ca) * mt_final
    if grid_slots > 4 * max_pairs:
        expansion = "compact"
    if (mt > settings.max_tiles_per_gauss or max_pairs > settings.max_pairs
            or tier_frac != settings.tier_frac
            or expansion != settings.expansion):
        print(
            f"budget probe: max tiles/gauss {mt_need} (cap "
            f"{settings.max_tiles_per_gauss} -> {mt}), pairs {pairs_need} "
            f"(budget {settings.max_pairs} -> {max_pairs}), tier_frac "
            f"{settings.tier_frac} -> {tier_frac}, expansion {expansion}"
        )
    return dataclasses.replace(
        settings,
        max_tiles_per_gauss=mt_final,
        max_pairs=max_pairs,
        tier_frac=float(tier_frac),
        expansion=expansion,
    )


def probe_rasterize_settings(state, cams, width, height):
    """Inference-time budget sizing: heuristics + on-model footprint probe
    (what render.py and the viewers call before rendering a trained
    model, whose largest gaussians can span hundreds of tiles)."""
    s = default_rasterize_settings(width, height, state.capacity)
    return _probe_initial_budgets(s, state, cams, width, height)
