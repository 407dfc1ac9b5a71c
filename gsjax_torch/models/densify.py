"""Adaptive density control (torch): the per-iteration statistics.

Counterpart of ``gsjax.models.densify``. This slice ports
:func:`add_densification_stats`; clone / split / prune and the opacity
reset (``densify_and_prune``, ``reset_opacity``) come next.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.models.gaussians import GaussianState


def add_densification_stats(state: GaussianState, grad_means2d_pix, radii, width, height):
    """Per-iteration bookkeeping (reference train.py:113-117,
    gaussian_model.py:405-407).

    ``grad_means2d_pix`` is the loss gradient with respect to pixel-space
    screen positions (the gradient of ``means2d_offset``); it is rescaled
    to NDC units (x by W/2, y by H/2) to match the units the reference CUDA
    backward reports and the 2e-4 threshold is tuned for."""
    visible = radii > 0
    scale = torch.tensor([width / 2.0, height / 2.0], dtype=torch.float32,
                         device=grad_means2d_pix.device)
    norms = torch.linalg.vector_norm(grad_means2d_pix * scale, dim=-1)
    return dataclasses.replace(
        state,
        max_radii2d=torch.where(
            visible, torch.maximum(state.max_radii2d, radii.to(torch.float32)),
            state.max_radii2d,
        ),
        xyz_grad_accum=state.xyz_grad_accum + torch.where(visible, norms, 0.0),
        denom=state.denom + visible.to(torch.float32),
    )
