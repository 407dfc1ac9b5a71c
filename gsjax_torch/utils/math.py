"""Quaternion / covariance math for anisotropic 3D Gaussians (torch).

Counterpart of ``gsjax.utils.math``; same conventions (reference:
utils/general_utils.py:64-110):

* quaternions are stored ``(w, x, y, z)`` and normalized before use;
* the Gaussian covariance is ``Sigma = (R S)(R S)^T`` with ``S = diag(scale)``;
* symmetric 3x3 matrices are "stripped" to their 6 upper-triangular elements
  in the order ``[xx, xy, xz, yy, yz, zz]``.
"""

from __future__ import annotations

import torch


def inverse_sigmoid(x):
    """Logit: inverse of the sigmoid opacity activation."""
    return torch.log(x / (1.0 - x))


def safe_normalize(x, dim=-1, eps=1e-12):
    """L2-normalize, finite at x = 0 (padding slots hold zeros)."""
    n2 = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(n2 + eps * eps)


def quat_to_rotmat(q):
    """Unit-normalize quaternion(s) ``(..., 4)`` in (w,x,y,z) order -> (..., 3, 3)."""
    q = safe_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1
    )
    r1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1
    )
    r2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([r0, r1, r2], dim=-2)


def build_covariance(scale, quat, scale_modifier=1.0):
    """Full 3D covariance Sigma = L L^T, ``(..., 3, 3)``, L = R diag(scale)."""
    L = quat_to_rotmat(quat) * (scale * scale_modifier)[..., None, :]
    return L @ L.transpose(-1, -2)


def strip_symmetric(sym):
    """Symmetric ``(..., 3, 3)`` -> 6-vector [xx, xy, xz, yy, yz, zz]."""
    return torch.stack(
        [
            sym[..., 0, 0],
            sym[..., 0, 1],
            sym[..., 0, 2],
            sym[..., 1, 1],
            sym[..., 1, 2],
            sym[..., 2, 2],
        ],
        dim=-1,
    )


def covariance6(scale, quat, scale_modifier=1.0):
    """3D covariance directly as the 6-vector [xx, xy, xz, yy, yz, zz].

    Same math as ``strip_symmetric(build_covariance(...))`` written in
    scalar channels, with gsjax's operation order."""
    q = safe_normalize(quat)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s = scale * scale_modifier
    u0, u1, u2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    xx = r00 * r00 * u0 + r01 * r01 * u1 + r02 * r02 * u2
    xy = r00 * r10 * u0 + r01 * r11 * u1 + r02 * r12 * u2
    xz = r00 * r20 * u0 + r01 * r21 * u1 + r02 * r22 * u2
    yy = r10 * r10 * u0 + r11 * r11 * u1 + r12 * r12 * u2
    yz = r10 * r20 * u0 + r11 * r21 * u1 + r12 * r22 * u2
    zz = r20 * r20 * u0 + r21 * r21 * u1 + r22 * r22 * u2
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)
