"""Adaptive density control (torch): statistics, clone / split / prune and
the opacity reset.

Counterpart of ``gsjax.models.densify``, with the decision rules of the
reference (scene/gaussian_model.py:349-407, train.py:112-123) on
fixed-capacity buffers: new Gaussians go to *free slots* (prefix-sum rank
-> free-slot index), pruned and split originals clear their ``active``
bit, and the Adam moments are zeroed at every written slot — the
reference's "new rows get zero moments" surgery
(gaussian_model.py:263-264, 315-316).

gsjax scatters with ``mode="drop"``: a child whose rank has no free slot
goes to index C and is lost. torch has no drop mode, so every scatter here
writes into a copy with one spare row C that is sliced off afterwards; a
rank never wraps onto a live slot. Every value written is read from the
pre-densify tensors, as gsjax's scatters read the pre-densify leaf: a
split's freed original slot can be a child's destination.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gsjax_torch.models.gaussians import GaussianState, Params
from gsjax_torch.utils import prng
from gsjax_torch.utils.math import inverse_sigmoid, quat_to_rotmat


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 2e-4  # reference train.py:118
    min_opacity: float = 0.005  # reference train.py:120
    percent_dense: float = 0.01  # reference arguments/__init__.py
    max_screen_size: float = 20.0  # reference train.py:119
    world_size_factor: float = 0.1  # reference gaussian_model.py:399
    n_split: int = 2  # reference gaussian_model.py:349
    split_shrink: float = 0.8  # new scale = old / (0.8 * n_split)
    opacity_reset_ceiling: float = 0.01  # reference gaussian_model.py:211


class DensifyStats(NamedTuple):
    """0-d int32 tensors. A pruned splat is counted in every prune cause it
    satisfies."""

    num_cloned: torch.Tensor
    num_split: torch.Tensor
    num_pruned: torch.Tensor
    num_dropped: torch.Tensor  # new points lost to capacity
    num_pruned_opacity: torch.Tensor
    num_pruned_screen: torch.Tensor
    num_pruned_world: torch.Tensor


def _densification_stats(state: GaussianState, grad_means2d_pix, radii, width, height):
    """The three statistics after one iteration: ``(max_radii2d,
    xyz_grad_accum, denom)``, new tensors. The NDC scale is filled on the
    device (a copy from the host would wait for the card), so a captured
    CUDA graph can hold it."""
    visible = radii > 0
    dev = grad_means2d_pix.device
    scale = torch.stack([torch.full((), v, dtype=torch.float32, device=dev)
                         for v in (width / 2.0, height / 2.0)])
    norms = torch.linalg.vector_norm(grad_means2d_pix * scale, dim=-1)
    return (
        torch.where(visible, torch.maximum(state.max_radii2d, radii.to(torch.float32)),
                    state.max_radii2d),
        state.xyz_grad_accum + torch.where(visible, norms, 0.0),
        state.denom + visible.to(torch.float32),
    )


def add_densification_stats(state: GaussianState, grad_means2d_pix, radii, width, height):
    """Per-iteration bookkeeping (reference train.py:113-117,
    gaussian_model.py:405-407): a new state with new statistics tensors.

    ``grad_means2d_pix`` is the loss gradient with respect to pixel-space
    screen positions (the gradient of ``means2d_offset``); it is rescaled
    to NDC units (x by W/2, y by H/2) to match the units the reference CUDA
    backward reports and the 2e-4 threshold is tuned for."""
    max_radii2d, xyz_grad_accum, denom = _densification_stats(
        state, grad_means2d_pix, radii, width, height)
    return dataclasses.replace(state, max_radii2d=max_radii2d,
                               xyz_grad_accum=xyz_grad_accum, denom=denom)


@torch.no_grad()
def add_densification_stats_(state: GaussianState, grad_means2d_pix, radii, width, height):
    """:func:`add_densification_stats` written into ``state``'s own
    statistics tensors, which keep their addresses (a captured train step
    reads and writes them at replay). Returns ``state``."""
    new = _densification_stats(state, grad_means2d_pix, radii, width, height)
    for old, value in zip((state.max_radii2d, state.xyz_grad_accum, state.denom), new):
        old.copy_(value)
    return state


def _free_slot_table(free):
    """slots_by_rank[r] = index of the r-th free slot (C where r >= n_free)."""
    c = free.shape[0]
    rank = torch.cumsum(free.to(torch.int64), 0) - 1
    table = torch.full((c + 1,), c, dtype=torch.int64, device=free.device)
    table[torch.where(free, rank, c)] = torch.arange(c, device=free.device)
    return table[:c]


def _dest(slots_by_rank, rank, mask):
    """Destination slot of each rank under ``mask``; C (dropped) where the
    rank has no free slot or the mask is off."""
    c = slots_by_rank.shape[0]
    d = slots_by_rank[rank.clamp(0, c - 1)]
    return torch.where(mask & (rank >= 0) & (rank < c), d, c)


def _scatter_rows(arr, dests, values):
    """``arr`` with rows ``values[k]`` written at ``dests[k]`` for each k, the
    rows sent to C dropped: a copy with a spare row C, sliced off."""
    c = arr.shape[0]
    out = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
    for d, v in zip(dests, values):
        out.index_copy_(0, d, v)
    return out[:c]


@torch.no_grad()
def densify_and_prune(
    state: GaussianState,
    mu: Params,
    nu: Params,
    key,
    extent: float,
    cfg: DensifyConfig = DensifyConfig(),
    use_screen_size: bool = False,
    eps: Optional[torch.Tensor] = None,
):
    """One densification step. Returns ``(state, mu, nu, stats)``: fresh
    parameter and moment tensors; ``state``, ``mu`` and ``nu`` are not
    modified.

    Decision rules (reference gaussian_model.py:374-401):
      clone:  grad >= thr and max(scale) <= percent_dense * extent — copy;
      split:  grad >= thr and max(scale) >  percent_dense * extent —
              n_split children at xyz + R @ (eps * scale), scale /= 0.8 n,
              original removed;
      prune:  opacity < min_opacity, plus (when ``use_screen_size``)
              screen radius > 20 px or world scale > 0.1 * extent.
    Prune is evaluated for new points too (with screen radius 0), as the
    reference prunes after it densifies.

    The split noise ``eps`` (n_split, C, 3) is gsjax's draw,
    ``normal(key, (n_split, C, 3))`` over the whole capacity with the
    ``utils.prng`` key ``key``, made on the state's device, unless it is
    given."""
    p = state.params
    active = state.active
    c = state.capacity
    dev = state.device

    grads = torch.where(state.denom > 0, state.xyz_grad_accum / state.denom,
                        torch.zeros_like(state.denom))
    scales = torch.exp(p["scaling"])
    max_scale = scales.amax(dim=-1)
    opac = torch.sigmoid(p["opacity"][:, 0])

    grad_ok = grads >= cfg.grad_threshold
    small = max_scale <= cfg.percent_dense * extent
    clone_mask = active & grad_ok & small
    split_mask = active & grad_ok & ~small

    def prune_fn(opacity, mscale, radii):
        m = opacity < cfg.min_opacity
        if use_screen_size:
            m = m | (radii > cfg.max_screen_size)
            m = m | (mscale > cfg.world_size_factor * extent)
        return m

    def count(m):
        return m.sum().to(torch.int32)

    keep = active & ~split_mask & ~prune_fn(opac, max_scale, state.max_radii2d)
    pr_base = active & ~split_mask
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    num_pruned = count(pr_base & ~keep)
    num_pr_op = count(pr_base & (opac < cfg.min_opacity))
    num_pr_scr = count(pr_base & (state.max_radii2d > cfg.max_screen_size)) \
        if use_screen_size else zero
    num_pr_wld = count(pr_base & (max_scale > cfg.world_size_factor * extent)) \
        if use_screen_size else zero

    zero_r = torch.zeros_like(state.max_radii2d)
    clone_keep = clone_mask & ~prune_fn(opac, max_scale, zero_r)
    child_scales = scales / (cfg.split_shrink * cfg.n_split)
    split_keep = split_mask & ~prune_fn(opac, child_scales.amax(dim=-1), zero_r)

    free = ~keep
    n_free = count(free)
    slots_by_rank = _free_slot_table(free)

    clone_cum = torch.cumsum(clone_keep.to(torch.int64), 0)
    total_clone = clone_cum[-1]
    split_cum = torch.cumsum(split_keep.to(torch.int64), 0)
    total_split = split_cum[-1]

    dests = [_dest(slots_by_rank, clone_cum - 1, clone_keep)]
    for k in range(cfg.n_split):
        rank = total_clone + k * total_split + (split_cum - 1)
        dests.append(_dest(slots_by_rank, rank, split_keep))

    # child positions: xyz + R @ (eps * scale), one sample per child
    # (reference gaussian_model.py:358-362)
    R = quat_to_rotmat(p["rotation"])
    if eps is None:
        eps = prng.normal(key, (cfg.n_split, c, 3), dev)
    child_xyz = [p["xyz"] + torch.einsum("nij,nj->ni", R, eps[k] * scales)
                 for k in range(cfg.n_split)]
    child_scaling = torch.log(torch.clamp_min(child_scales, 1e-30))

    new_params = {}
    for name, leaf in p.items():
        leaf = leaf.detach()
        if name == "xyz":
            vals = child_xyz
        elif name == "scaling":
            vals = [child_scaling] * cfg.n_split
        else:
            vals = [leaf] * cfg.n_split
        new_params[name] = _scatter_rows(leaf, dests, [leaf] + vals)  # clones copy everything

    written = _scatter_rows(torch.zeros(c, dtype=torch.bool, device=dev), dests,
                            [torch.ones(c, dtype=torch.bool, device=dev)] * len(dests))
    new_active = keep | written
    new_mu = {k: torch.where(_rows(written, v), torch.zeros_like(v), v) for k, v in mu.items()}
    new_nu = {k: torch.where(_rows(written, v), torch.zeros_like(v), v) for k, v in nu.items()}

    total_new = total_clone + cfg.n_split * total_split
    stats = DensifyStats(
        num_cloned=total_clone.to(torch.int32),
        num_split=total_split.to(torch.int32),
        num_pruned=num_pruned,
        num_dropped=torch.clamp_min(total_new - n_free, 0).to(torch.int32),
        num_pruned_opacity=num_pr_op,
        num_pruned_screen=num_pr_scr,
        num_pruned_world=num_pr_wld,
    )
    new_state = dataclasses.replace(
        state,
        params=new_params,
        active=new_active,
        # the reference resets all accumulators after densify
        # (gaussian_model.py:345-347) and prunes their rows; with fixed
        # capacity a full zero covers both
        max_radii2d=torch.zeros_like(state.max_radii2d),
        xyz_grad_accum=torch.zeros_like(state.xyz_grad_accum),
        denom=torch.zeros_like(state.denom),
    )
    return new_state, new_mu, new_nu, stats


def _rows(mask, like):
    """``mask`` (C,) broadcast over the trailing dimensions of ``like``."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


@torch.no_grad()
def reset_opacity(state: GaussianState, mu: Params, nu: Params, cfg=DensifyConfig()):
    """Clamp every active opacity to <= the ceiling and zero the opacity
    moments (reference gaussian_model.py:210-213, 258-271). Returns
    ``(state, mu, nu)`` with a fresh opacity tensor."""
    opacity = state.params["opacity"].detach()
    new_op = inverse_sigmoid(torch.clamp_max(torch.sigmoid(opacity), cfg.opacity_reset_ceiling))
    params = dict(state.params)
    params["opacity"] = torch.where(state.active[:, None], new_op, opacity)
    mu, nu = dict(mu), dict(nu)
    mu["opacity"] = torch.zeros_like(mu["opacity"])
    nu["opacity"] = torch.zeros_like(nu["opacity"])
    return dataclasses.replace(state, params=params), mu, nu
