"""One training iteration, plainly: render, 0.8 L1 + 0.2 (1 - SSIM), the
gradients through the blend and preprocess, Adam in optax's float32
order, and the densification statistics (reference 3DGS train.py:51-128,
scene/gaussian_model.py:149-175 and 405-407).

The blend's gradient comes from :class:`.render.Blend` (autograd over one
chunk at a time); the rest is autograd over plain tensor code.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gsbench.reference import render as R

PARAM_KEYS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
BETAS = (0.9, 0.999)
EPS = 1e-15


# ---- loss (reference utils/loss_utils.py:17-63) ---------------------------

def _window(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return [float(v) for v in g / g.sum()]


def _blur(x, dim, taps):
    pad = len(taps) // 2
    n = x.shape[dim]
    xp = F.pad(x, (pad, pad, 0, 0) if dim == 2 else (0, 0, pad, pad))
    out = None
    for i, w in enumerate(taps):
        s = xp.narrow(dim, i, n) * w
        out = s if out is None else out + s
    return out


def ssim(img, gt):
    """Mean SSIM, 11x11 gaussian window (sigma 1.5), zero padding."""
    x, y = img.permute(2, 0, 1), gt.permute(2, 0, 1)
    taps = _window()
    f = _blur(_blur(torch.cat([x, y, x * x, y * y, x * y], 0), 1, taps), 2, taps)
    mu1, mu2, exx, eyy, exy = (f[i * 3:(i + 1) * 3] for i in range(5))
    m11, m22, m12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2 * m12 + c1) * (2 * (exy - m12) + c2)
    den = (m11 + m22 + c1) * ((exx - m11) + (eyy - m22) + c2)
    return (num / den).mean()


def loss_fn(img, gt, lambda_dssim=0.2):
    return (1.0 - lambda_dssim) * (img - gt).abs().mean() + lambda_dssim * (1.0 - ssim(img, gt))


# ---- Adam ------------------------------------------------------------------

def xyz_lr(step: int, lr_init: float, lr_final: float, max_steps: int) -> float:
    """The reference's log-linear xyz decay (no delay ramp), in float32."""
    s = torch.tensor(float(step), dtype=torch.float32)
    t = torch.clamp(s / max_steps, 0.0, 1.0)
    return float(torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t))


def group_lrs(opt: dict, extent: float, iteration: int) -> dict:
    """Each group's learning rate at ``iteration`` (1-based): xyz on its
    schedule scaled by the scene radius, f_rest at feature_lr / 20."""
    return {
        "xyz": xyz_lr(iteration, opt["position_lr_init"] * extent,
                      opt["position_lr_final"] * extent, opt["position_lr_max_steps"]),
        "features_dc": opt["feature_lr"],
        "features_rest": opt["feature_lr"] / 20.0,
        "opacity": opt["opacity_lr"],
        "scaling": opt["scaling_lr"],
        "rotation": opt["rotation_lr"],
    }


@torch.no_grad()
def adam_(params, grads, mu, nu, count: int, lrs: dict):
    """optax's scale_by_adam then -lr, in place, each product and sum
    rounded to the parameters' dtype once: ``mu = b1 mu + (1 - b1) g``,
    ``nu = b2 nu + (1 - b2) g g``, ``p -= lr (mu / bc1) / (sqrt(nu / bc2)
    + eps)`` with ``bc = 1 - b ** count`` in float32."""
    b1, b2 = BETAS
    f32 = torch.float32
    bc1 = float(1 - torch.tensor(b1, dtype=f32) ** torch.tensor(float(count), dtype=f32))
    bc2 = float(1 - torch.tensor(b2, dtype=f32) ** torch.tensor(float(count), dtype=f32))
    for k in PARAM_KEYS:
        p, g = params[k], grads[k]
        dev, dt = p.device, p.dtype
        mu[k].mul_(b1).add_(g * (1 - b1))
        nu[k].mul_(b2).add_((g * g) * (1 - b2))
        den = torch.sqrt(nu[k] / torch.tensor(bc2, dtype=dt, device=dev)) + EPS
        upd = (mu[k] / torch.tensor(bc1, dtype=dt, device=dev)) / den
        lr = float(torch.tensor(lrs[k], dtype=f32))
        p.sub_(upd * lr)


# ---- one step --------------------------------------------------------------

def step(params: dict, active, stats: dict, mu: dict, nu: dict, count: int, cam: dict,
         gt, bg, sh_degree: int, tie: str, lrs: dict, lambda_dssim: float = 0.2) -> dict:
    """One iteration from ``params`` (updated in place, as ``mu``, ``nu``
    and ``stats``); ``count`` is Adam's count after this step. Returns the
    loss, the gradients (the optimizer's input) and the blended (pair,
    pixel) steps."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    cap = active.shape[0]
    dt = params["xyz"].dtype
    offset = torch.zeros((cap, 2), dtype=dt, device=active.device, requires_grad=True)
    w, h = cam["width"], cam["height"]
    with torch.enable_grad():
        sp = R.preprocess(*R.activations(leaves), cam, sh_degree, active,
                          means2d_offset=offset)
    pg, ts = R.pairs(sp, w, h, tie)
    blend = R.Blend(pg, ts, sp.means2d, sp.conics, sp.colors, sp.opacities, w, h)
    tc, tT = blend.forward()
    tc, tT = tc.requires_grad_(True), tT.requires_grad_(True)
    with torch.enable_grad():
        img = R.assemble(tc, tT, bg, w, h)
        loss = loss_fn(img, gt.to(dt), lambda_dssim)
        d_tc, d_tT = torch.autograd.grad(loss, [tc, tT])
    g2d = blend.backward(d_tc, d_tT)
    torch.autograd.backward([sp.means2d, sp.conics, sp.colors, sp.opacities], g2d)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    adam_(params, grads, mu, nu, count, lrs)
    with torch.no_grad():
        visible = sp.radii > 0
        scale = torch.tensor([w / 2.0, h / 2.0], dtype=dt, device=active.device)
        norms = torch.linalg.vector_norm(offset.grad * scale, dim=-1)
        stats["max_radii2d"] = torch.where(
            visible, torch.maximum(stats["max_radii2d"], sp.radii.to(dt)), stats["max_radii2d"])
        stats["xyz_grad_accum"] = stats["xyz_grad_accum"] + torch.where(visible, norms, 0.0)
        stats["denom"] = stats["denom"] + visible.to(dt)
    return {"loss": float(loss.detach()), "grads": grads, "blended": blend.blended}


def run(params0: dict, active, cams: list, targets, cam_order, bg, sh_degree: int,
        tie: str, opt: dict, extent: float, start_iteration: int, dtype=torch.float32):
    """``len(cam_order)`` iterations from ``params0`` (not changed), Adam's
    moments and the statistics starting at 0 and the learning rates at
    ``start_iteration``. ``targets[i]`` is camera ``i``'s uint8 image.
    Returns ``(params, mu, nu, stats, losses, first_grads)``."""
    params = {k: v.detach().to(dtype).clone() for k, v in params0.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    cap = active.shape[0]
    z = torch.zeros(cap, dtype=dtype, device=active.device)
    stats = {"max_radii2d": z.clone(), "xyz_grad_accum": z.clone(), "denom": z.clone()}
    losses, first = [], None
    for i, c in enumerate(cam_order):
        gt = targets[c].to(dtype) / 255.0
        lrs = group_lrs(opt, extent, start_iteration + i + 1)
        out = step(params, active, stats, mu, nu, i + 1, cams[c], gt, bg.to(dtype),
                   sh_degree, tie, lrs)
        losses.append(out["loss"])
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g.float())) for k, g in out["grads"].items()}
    return params, mu, nu, stats, losses, first
