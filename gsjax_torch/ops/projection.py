"""Per-Gaussian preprocess: culling, EWA splatting, SH->RGB (torch).

Counterpart of ``gsjax.ops.projection`` with the same semantics as the
reference CUDA ``preprocess`` kernel (diff-gaussian-rasterization
forward.cu): near-plane cull at view z <= 0.2, EWA projection
J W Sigma W^T J^T with the +0.3 px low-pass on the 2D covariance diagonal,
3-sigma pixel radius from the larger eigenvalue, 16x16 touched-tile
rectangles, and SH evaluation clamped at 0 after the +0.5 DC offset.

:func:`preprocess_plain` is the definition: batched tensor ops over the
Gaussian axis, in gsjax's operation order. :func:`preprocess_infer` launches
the hand-written CUDA kernel ``csrc/preprocess_infer.cu``, which computes
the same fields in one pass. :func:`preprocess` picks between them by the
rule ``render`` applies to compositing: CUDA tensors with no gradient
wanted take the kernel; under autograd, and for CPU tensors, the plain
version runs. Nothing falls back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gsjax_torch.data.cameras import CAMERA_TENSORS, RenderCamera
from gsjax_torch.utils import profiling
from gsjax_torch.utils.math import covariance6, safe_normalize
from gsjax_torch.utils.sh import eval_sh

TILE = 16
NEAR_CULL_Z = 0.2  # reference CUDA in_frustum near threshold
LOW_PASS = 0.3  # EWA low-pass added to cov2d diagonal
MIN_LAMBDA = 0.1  # eigenvalue clamp inside radius computation


class Splats(NamedTuple):
    """Per-Gaussian screen-space quantities (all shape (N, ...))."""

    means2d: torch.Tensor  # (N, 2) pixel coords
    depths: torch.Tensor  # (N,) view-space z
    conics: torch.Tensor  # (N, 3) inverse 2D covariance [a, b, c]
    colors: torch.Tensor  # (N, 3) RGB
    opacities: torch.Tensor  # (N,)
    radii: torch.Tensor  # (N,) int32 pixel radius, 0 => culled
    rect_min: torch.Tensor  # (N, 2) int32 tile coords (x, y), inclusive
    rect_max: torch.Tensor  # (N, 2) int32 tile coords, exclusive
    tiles_touched: torch.Tensor  # (N,) int32


def num_tiles(width: int, height: int):
    return -(-width // TILE), -(-height // TILE)


def quantize_f16(x):
    """Round to the nearest float16 value (denormals flushed to zero),
    returned in float32.

    Every gsjax backend quantizes per-Gaussian colors and opacities this
    way, and the compositing kernel reads them as packed f16 halves, so the
    port does the same in :func:`preprocess`. Values above 65504 round to
    inf, as in gsjax (no clamp)."""
    q = x.to(torch.float16).to(torch.float32)
    return torch.where(q.abs() < 2.0 ** -14, torch.zeros_like(q), q)


def project_points(means3d, camera: RenderCamera):
    """World points -> (view z, pixel xy)."""
    ones = torch.ones_like(means3d[:, :1])
    hom = torch.cat([means3d, ones], dim=1)  # (N, 4)
    p_view = hom @ camera.world_view.T  # (N, 4)
    p_hom = hom @ camera.full_proj.T  # (N, 4)
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc = p_hom[:, :2] * p_w[:, None]
    # ndc2Pix(v, S) = ((v + 1) * S - 1) / 2
    px = ((ndc[:, 0] + 1.0) * camera.width - 1.0) * 0.5
    py = ((ndc[:, 1] + 1.0) * camera.height - 1.0) * 0.5
    return p_view[:, 2], torch.stack([px, py], dim=1)


def ewa_project(means3d, cov3d_flat, camera: RenderCamera):
    """EWA: 3D covariance -> 2D screen covariance (upper-left 2x2 of
    J W Sigma W^T J^T) with the +0.3 low-pass. Returns (N, 3) [xx, xy, yy].

    Scalar channels, as gsjax writes it: M = J @ W has rows
    m0 = fx/tz * W0 - fx tx/tz^2 * W2 and m1 = fy/tz * W1 - fy ty/tz^2 * W2."""
    W = camera.world_view[:3, :3]
    ones = torch.ones_like(means3d[:, :1])
    t = (torch.cat([means3d, ones], dim=1) @ camera.world_view.T)[:, :3]
    # keep 1/z finite for culled/inactive points
    tz = t[:, 2]
    tz = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    lim_x = 1.3 * camera.tan_fov_x
    lim_y = 1.3 * camera.tan_fov_y
    tx = torch.clamp(t[:, 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(t[:, 1] / tz, -lim_y, lim_y) * tz
    inv_z = 1.0 / tz
    a = camera.focal_x * inv_z  # (N,)
    b = camera.focal_y * inv_z
    c = -camera.focal_x * tx * inv_z * inv_z
    d = -camera.focal_y * ty * inv_z * inv_z

    m0 = [a * W[0, k] + c * W[2, k] for k in range(3)]
    m1 = [b * W[1, k] + d * W[2, k] for k in range(3)]

    sxx, sxy, sxz = cov3d_flat[:, 0], cov3d_flat[:, 1], cov3d_flat[:, 2]
    syy, syz, szz = cov3d_flat[:, 3], cov3d_flat[:, 4], cov3d_flat[:, 5]

    def sig_dot(v):  # Sigma @ v, v a list of 3 (N,) tensors
        return (
            sxx * v[0] + sxy * v[1] + sxz * v[2],
            sxy * v[0] + syy * v[1] + syz * v[2],
            sxz * v[0] + syz * v[1] + szz * v[2],
        )

    s0 = sig_dot(m0)
    s1 = sig_dot(m1)
    cov00 = m0[0] * s0[0] + m0[1] * s0[1] + m0[2] * s0[2]
    cov01 = m0[0] * s1[0] + m0[1] * s1[1] + m0[2] * s1[2]
    cov11 = m1[0] * s1[0] + m1[1] * s1[1] + m1[2] * s1[2]
    return torch.stack([cov00 + LOW_PASS, cov01, cov11 + LOW_PASS], dim=1)


def preprocess(
    means3d,
    scales,
    quats,
    opacities,
    shs,
    camera: RenderCamera,
    sh_degree: int,
    *,
    scale_modifier=1.0,
    cov3d_precomp: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    active_mask: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    opacity_aware_radius: bool = True,
) -> Splats:
    """Full preprocess. All inputs post-activation (exp scales, normalized
    quats, sigmoid opacities) — the CUDA rasterizer binding's contract
    (reference: gaussian_renderer/__init__.py:85-93).

    CUDA tensors with no gradient wanted (grad disabled, or no input that
    requires grad) launch :func:`preprocess_infer`; everything else runs
    :func:`preprocess_plain`."""
    inputs = (means3d, scales, quats, opacities, shs, cov3d_precomp, colors_precomp,
              means2d_offset, *(getattr(camera, k) for k in CAMERA_TENSORS))
    wants_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)
    fn = preprocess_infer if means3d.device.type == "cuda" and not wants_grad else preprocess_plain
    return fn(means3d, scales, quats, opacities, shs, camera, sh_degree,
              scale_modifier=scale_modifier, cov3d_precomp=cov3d_precomp,
              colors_precomp=colors_precomp, active_mask=active_mask,
              means2d_offset=means2d_offset, opacity_aware_radius=opacity_aware_radius)


def preprocess_plain(
    means3d,
    scales,
    quats,
    opacities,
    shs,
    camera: RenderCamera,
    sh_degree: int,
    *,
    scale_modifier=1.0,
    cov3d_precomp: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    active_mask: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    opacity_aware_radius: bool = True,
) -> Splats:
    """:func:`preprocess` in batched tensor ops, differentiable: the
    definition, on any device."""
    depths, means2d = project_points(means3d, camera)
    if means2d_offset is not None:
        means2d = means2d + means2d_offset

    # f16 quantization before the opacity-aware radius, so the binning
    # rectangle bounds the alpha the compositing kernel evaluates
    opacities = quantize_f16(opacities.reshape(-1))

    if cov3d_precomp is None:
        cov3d_flat = covariance6(scales, quats, scale_modifier)
    else:
        cov3d_flat = cov3d_precomp
    cov2d = ewa_project(means3d, cov3d_flat, camera)

    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
    det_ok = det > 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    conics = (
        torch.stack([cov2d[:, 2], -cov2d[:, 1], cov2d[:, 0]], dim=1)
        / safe_det[:, None]
    )

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, MIN_LAMBDA))
    radii_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    valid = (depths > NEAR_CULL_Z) & det_ok
    if active_mask is not None:
        valid = valid & active_mask

    tiles_x, tiles_y = num_tiles(camera.width, camera.height)

    def rects_of(r):
        rmin = torch.stack(
            [
                torch.clamp(torch.floor((means2d[:, 0] - r) / TILE), 0, tiles_x),
                torch.clamp(torch.floor((means2d[:, 1] - r) / TILE), 0, tiles_y),
            ],
            dim=1,
        ).to(torch.int32)
        rmax = torch.stack(
            [
                torch.clamp(torch.floor((means2d[:, 0] + r + TILE - 1) / TILE), 0, tiles_x),
                torch.clamp(torch.floor((means2d[:, 1] + r + TILE - 1) / TILE), 0, tiles_y),
            ],
            dim=1,
        ).to(torch.int32)
        touched = (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1])
        return rmin, rmax, touched

    # reported radii / visibility keep the reference's plain 3-sigma rect
    _, _, tiles3 = rects_of(radii_f)
    valid = valid & (tiles3 > 0)
    radii = torch.where(valid, radii_f, torch.zeros_like(radii_f)).to(torch.int32)

    # Binning uses the opacity-aware radius min(3 sigma, r_op): alpha(d) <=
    # op * exp(-|d|^2 / (2 lambda1)), so pixels beyond
    # r_op = sqrt(2 ln(op / ALPHA_MIN) * lambda1) never pass the 1/255 cut
    # (+1 px: the rect's max edge covers pixels to mean + r - 1). Bit-exact
    # pair-count reduction; structural only, so no gradient flows here.
    if opacity_aware_radius:
        with torch.no_grad():
            chi = 2.0 * torch.log(255.0 * torch.clamp_min(opacities, 1e-12))
            r_bin = torch.minimum(
                radii_f,
                torch.ceil(torch.sqrt(torch.clamp_min(chi, 0.0) * lambda1)) + 1.0,
            )
            rect_min, rect_max, tiles_bin = rects_of(r_bin)
        tiles_touched = torch.where(
            valid & (chi > 0.0), tiles_bin, torch.zeros_like(tiles_bin)
        )
    else:
        rect_min, rect_max, tiles_bin = rects_of(radii_f)
        tiles_touched = torch.where(valid, tiles_bin, torch.zeros_like(tiles_bin))

    if colors_precomp is None:
        dirs = safe_normalize(means3d - camera.camera_center[None, :])
        colors = torch.clamp_min(eval_sh(shs, dirs, sh_degree) + 0.5, 0.0)
    else:
        colors = colors_precomp
    colors = quantize_f16(colors)

    return Splats(
        means2d=means2d,
        depths=depths,
        conics=conics,
        colors=colors,
        opacities=opacities,
        radii=radii,
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=tiles_touched.to(torch.int32),
    )


def preprocess_infer(
    means3d,
    scales,
    quats,
    opacities,
    shs,
    camera: RenderCamera,
    sh_degree: int,
    *,
    scale_modifier=1.0,
    cov3d_precomp: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    active_mask: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    opacity_aware_radius: bool = True,
) -> Splats:
    """:func:`preprocess_plain`'s fields from one launch of
    ``csrc/preprocess_infer.cu`` on the current stream, for float32 CUDA
    tensors; no gradient flows. ``shs`` is (N, K, 3) with K <= 16.

    On the card at K = 16, the port's SH rows, the integer fields of
    every slot and the float fields of every used slot (``radii > 0``)
    equal the plain version's bit for bit; with fewer coefficients a row
    the colors may differ by the SH sum's order, at most one f16 step.
    Slots with ``radii == 0`` (``tiles_touched`` is 0 there too) feed no
    pair, and their ``colors`` are 0 unless ``colors_precomp`` is given.

    Each call counts in ``preprocess_infer.launches`` and in the registry's
    counter ``preprocess.kernel`` (``utils.profiling``). ``launches`` is
    the kernels that ran: ``utils.graphs`` adds a graph's launches at each
    replay and takes back its capture's. The registry's counter counts
    calls on the host: a graphed frame counts at its capture (once for its
    eager warm-up, once for the capture itself) and never at a replay."""
    dev = means3d.device
    if dev.type != "cuda":
        raise RuntimeError(f"preprocess_infer runs on CUDA tensors, not {dev}")
    n = means3d.shape[0]
    k = shs.shape[1] if shs.dim() == 3 else 0
    if colors_precomp is None and (shs.shape[0] != n or k > 16 or shs.shape[-1] != 3):
        raise ValueError(f"shs must be (N, K <= 16, 3), got {tuple(shs.shape)}")

    def arg(x, *shape, dtype=torch.float32):
        if x is None:
            return None
        if x.dtype != dtype or x.device != dev:
            raise ValueError(f"preprocess_infer takes {dtype} tensors on {dev}, "
                             f"got {x.dtype} on {x.device}")
        return x.reshape(*shape).contiguous()

    ins = [arg(means3d, n, 3), arg(scales, n, 3), arg(quats, n, 4), arg(opacities, n),
           arg(shs, n, k, 3) if colors_precomp is None else None,
           arg(cov3d_precomp, n, 6), arg(colors_precomp, n, 3),
           arg(active_mask, n, dtype=torch.bool), arg(means2d_offset, n, 2)]
    ins += [arg(getattr(camera, name), -1) for name in CAMERA_TENSORS]

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32 = torch.int32
    out = Splats(means2d=empty(n, 2), depths=empty(n), conics=empty(n, 3),
                 colors=empty(n, 3), opacities=empty(n), radii=empty(n, dtype=i32),
                 rect_min=empty(n, 2, dtype=i32), rect_max=empty(n, 2, dtype=i32),
                 tiles_touched=empty(n, dtype=i32))
    from gsjax_torch.ops.cuda_composite import _launch, load_library  # it imports TILE from here

    k_used = min(k, (min(max(int(sh_degree), 0), 3) + 1) ** 2)
    with torch.cuda.device(dev):
        _launch("preprocess_infer", load_library().gsjax_preprocess_infer,
                *(0 if x is None else x.data_ptr() for x in ins),
                *(x.data_ptr() for x in out), n, k, k_used, camera.width, camera.height,
                float(scale_modifier), int(bool(opacity_aware_radius)))
    preprocess_infer.launches += 1
    profiling.count("preprocess.kernel")
    return out


preprocess_infer.launches = 0
