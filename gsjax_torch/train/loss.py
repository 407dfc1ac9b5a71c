"""Photometric losses: L1, L2 and windowed SSIM (torch).

Counterpart of ``gsjax.train.loss``, with the reference's exact constants
(utils/loss_utils.py:17-63): 11x11 Gaussian window, sigma = 1.5,
C1 = 0.01^2, C2 = 0.03^2, zero padding at the borders. Images are
(H, W, 3) in [0, 1].

The window is separable, so SSIM blurs with two 11-tap 1D passes, written
as gsjax writes them: shift-multiply-adds over a zero-padded tensor, plain
elementwise tensor ops in float32. That keeps the result exact in float32
on every device; a float32 ``F.conv2d`` on the card would run through
cuDNN in TF32 by default (``torch.backends.cudnn.allow_tf32``), keeping
about three digits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred, gt):
    return (pred - gt).abs().mean()


def l2_loss(pred, gt):
    return ((pred - gt) ** 2).mean()


@functools.lru_cache(maxsize=None)
def _window_1d(window_size: int, sigma: float):
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return tuple(float(v) for v in (g / g.sum()))


def _blur_axis(x, dim: int, taps):
    """Separable 1D Gaussian along ``dim`` (1 or 2 of a (C, H, W) tensor)
    as shift-multiply-adds over a zero-padded copy."""
    pad = len(taps) // 2
    n = x.shape[dim]
    widths = (pad, pad, 0, 0) if dim == 2 else (0, 0, pad, pad)
    xp = F.pad(x, widths)
    out = None
    for i, w in enumerate(taps):
        sl = xp.narrow(dim, i, n)
        out = sl * w if out is None else out + sl * w
    return out


def _depthwise_filter(imgs, window_size, sigma):
    """imgs: (C, H, W) -> Gaussian-filtered (C, H, W), zero ('same') padding."""
    taps = _window_1d(window_size, sigma)
    return _blur_axis(_blur_axis(imgs, 1, taps), 2, taps)


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM over the image; inputs (H, W, 3) in [0, 1]."""
    x = img1.permute(2, 0, 1)  # (3, H, W)
    y = img2.permute(2, 0, 1)
    stacked = torch.cat([x, y, x * x, y * y, x * y], dim=0)  # (15, H, W)
    return ssim_map(_depthwise_filter(stacked, window_size, sigma)).mean()


def ssim_map(f):
    """The SSIM map (3, H, W) from the filtered stack ``f`` (15, H, W) of
    x, y, x*x, y*y and x*y. The sharded path's strip SSIM shares it, so
    both differentiate the same graph: each term reused as here, the
    gradients summed in the same order."""
    mu1, mu2, exx, eyy, exy = (f[i * 3:(i + 1) * 3] for i in range(5))
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = exx - mu1_sq
    sigma2_sq = eyy - mu2_sq
    sigma12 = exy - mu12
    c1, c2 = 0.01**2, 0.03**2
    return ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )


def photometric_loss(pred, gt, lambda_dssim: float = 0.2):
    """0.8 * L1 + 0.2 * (1 - SSIM) (reference train.py:90-93)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (
        1.0 - ssim(pred, gt)
    )
