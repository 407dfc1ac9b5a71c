"""One training iteration and one frame, called layer by layer through the
program's own functions, each layer under a ``gsbench.<layer>`` span, so a
profiled call splits the device time by layer (the split that the port's
smoke test times with CUDA events, read here from the trace).

The calls are the ones ``render`` and the train step make, in their
order, on the cell's own state and camera; only their summed device time
is read, so launch gaps count for nothing.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function


def train_iteration(state, opt, rcam, gt, cfg):
    """An eager training iteration split into the layers ``prep.train``
    (preprocess and binning), ``composite_fwd`` (pack and the forward
    kernel), ``loss`` (assemble, L1 + SSIM and their backward),
    ``composite_bwd``, ``reduce``, ``prep_bwd`` (autograd through
    preprocess and the activations) and ``adam``. It updates the state."""
    from gsjax_torch.ops.binning import build_tile_bins
    from gsjax_torch.ops.composite import assemble_image
    from gsjax_torch.ops.cuda_composite import (
        composite_bwd, composite_fwd, pack_gauss_attrs, reduce_pair_grads,
    )
    from gsjax_torch.ops.projection import num_tiles, preprocess
    from gsjax_torch.train.loss import l1_loss, ssim
    from gsjax_torch.train.step import _activated_from

    s = cfg.settings
    tx, ty = num_tiles(rcam.width, rcam.height)
    dev = gt.device
    opt.zero_grad(set_to_none=True)
    with record_function("gsbench.prep.train"):
        offset = torch.zeros((state.capacity, 2), device=dev, requires_grad=True)
        sp = preprocess(*_activated_from(state.params), rcam, state.active_sh_degree,
                        active_mask=state.active, means2d_offset=offset,
                        opacity_aware_radius=s.opacity_aware_radius)
        bins = build_tile_bins(sp, tx, ty, s.max_pairs, exact_depth_sort=s.exact_depth_sort,
                               max_tiles_per_gauss=s.max_tiles_per_gauss,
                               tier_frac=s.tier_frac, expansion=s.expansion)
    blend = (sp.means2d, sp.conics, sp.colors, sp.opacities)
    with record_function("gsbench.composite_fwd"):
        attrs = pack_gauss_attrs(*(t.detach() for t in blend))
        tc, tT, ncon = composite_fwd(bins.tile_start, bins.pair_gauss, attrs, tx, ty)
    with record_function("gsbench.loss"):
        tc.requires_grad_(True)
        tT.requires_grad_(True)
        img, _ = assemble_image(tc, tT, torch.zeros(3, device=dev), tx, ty,
                                rcam.width, rcam.height)
        loss = ((1.0 - cfg.lambda_dssim) * l1_loss(img, gt)
                + cfg.lambda_dssim * (1.0 - ssim(img, gt)))
        d_tc, d_tT = torch.autograd.grad(loss, [tc, tT])
    with record_function("gsbench.composite_bwd"):
        pair_grads = composite_bwd(bins.tile_start, bins.pair_gauss, attrs, d_tc, d_tT,
                                   tT.detach(), ncon, tx, ty, grad_dtype=s.grad_dtype,
                                   grad_reduce=s.grad_reduce)
    with record_function("gsbench.reduce"):
        per = reduce_pair_grads(pair_grads, bins.pair_gauss, bins.tile_start, attrs.shape[0])
    with record_function("gsbench.prep_bwd"):
        torch.autograd.backward(list(blend), [per[:, 0:2], per[:, 2:5], per[:, 6:9], per[:, 5]])
    with record_function("gsbench.adam"):
        opt.step()
    opt.zero_grad(set_to_none=True)
    return float(loss.detach())


@torch.no_grad()
def view_frame(state, rcam, settings):
    """An eager frame's preprocess and binning under ``prep.view``, then
    the rest of the frame (pack, ``composite_infer``, assemble)."""
    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.ops.binning import build_tile_bins
    from gsjax_torch.ops.composite import assemble_image
    from gsjax_torch.ops.cuda_composite import composite_infer, pack_gauss_attrs
    from gsjax_torch.ops.projection import num_tiles, preprocess

    s = settings
    tx, ty = num_tiles(rcam.width, rcam.height)
    with record_function("gsbench.prep.view"):
        sp = preprocess(*activated(state), rcam, state.active_sh_degree,
                        active_mask=state.active, opacity_aware_radius=s.opacity_aware_radius)
        bins = build_tile_bins(sp, tx, ty, s.max_pairs, exact_depth_sort=s.exact_depth_sort,
                               max_tiles_per_gauss=s.max_tiles_per_gauss,
                               tier_frac=s.tier_frac, expansion=s.expansion)
    with record_function("gsbench.composite_infer"):
        attrs = pack_gauss_attrs(sp.means2d, sp.conics, sp.colors, sp.opacities)
        tc, tT = composite_infer(bins.tile_start, bins.pair_gauss, attrs, tx, ty)
        assemble_image(tc, tT, torch.zeros(3, device=tc.device), tx, ty, rcam.width,
                       rcam.height)
