"""Real spherical harmonics, degrees 0..3 (torch).

Counterpart of ``gsjax.utils.sh``: the same hardcoded real SH basis as the
reference (utils/sh_utils.py:26-118); colors are stored as SH coefficients
with the DC term offset so that ``rgb = clamp(eval_sh(...) + 0.5, 0)``.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

# band index (0..3) of each of the 16 coefficients, for degree masking
_BAND = (0,) + (1,) * 3 + (2,) * 5 + (3,) * 7


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(dirs):
    """The 16 real SH basis functions at unit directions ``(..., 3)`` -> ``(..., 16)``."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = torch.ones_like(x)
    return torch.stack(
        [
            C0 * one,
            -C1 * y,
            C1 * z,
            -C1 * x,
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ],
        dim=-1,
    )


def eval_sh(sh, dirs, degree: int):
    """SH color. ``sh``: ``(..., K, 3)`` with K <= 16, ``dirs``: ``(..., 3)``.

    Bands above ``degree`` are masked out (gsjax masks instead of slicing so
    one compiled program serves the SH ramp; the port keeps the masking so
    the sums run over the same terms). Returns raw SH color ``(..., 3)``;
    callers add the +0.5 DC offset."""
    k = sh.shape[-2]
    mask = torch.tensor(
        [float(b <= degree) for b in _BAND[:k]], dtype=sh.dtype, device=sh.device
    )
    basis = sh_basis(dirs)[..., :k] * mask
    return torch.einsum("...k,...kc->...c", basis, sh)


def rgb_to_sh(rgb):
    """DC coefficient from linear RGB (reference: utils/sh_utils.py RGB2SH)."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    """Linear RGB from DC coefficient (reference: utils/sh_utils.py SH2RGB)."""
    return sh * C0 + 0.5
