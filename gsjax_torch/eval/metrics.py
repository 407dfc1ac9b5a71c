"""PSNR / MSE (reference: utils/image_utils.py:14-19).

Counterpart of ``gsjax.eval.metrics``. SSIM lives in
:mod:`gsjax_torch.train.loss` (shared with the training loss).
"""

from __future__ import annotations

import torch


def mse(img1, img2):
    return ((img1 - img2) ** 2).mean()


def psnr(img1, img2):
    """Peak signal-to-noise ratio for [0,1] images (any shape)."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))
