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
the same fields in one pass. :func:`preprocess_train` is the plain version
as one ``torch.autograd.Function``: its forward runs the plain version with
nothing recorded, and its backward is one launch of
``csrc/preprocess_bwd.cu`` (:func:`preprocess_bwd`), whose closed form
:func:`preprocess_vjp_plain` writes out in tensor ops, term by term.

:func:`preprocess` picks by what it sees in its inputs (:func:`preprocess_path`):
CPU tensors run the plain version; CUDA tensors with no gradient wanted
take ``preprocess_infer``; CUDA tensors under autograd take
``preprocess_train``, unless a precomputed covariance or colors (the
reference's ``compute_cov3d_python`` / ``convert_shs_python`` toggles) or a
camera tensor that requires grad asks for gradients the kernel does not
give: those run the plain version under autograd. Nothing falls back.
"""

from __future__ import annotations

import types
from typing import NamedTuple, Optional

import torch

from gsjax_torch.data.cameras import CAMERA_TENSORS, RenderCamera
from gsjax_torch.ops import kernels
from gsjax_torch.utils.math import covariance6, safe_normalize
from gsjax_torch.utils.sh import band_mask, eval_sh, sh_basis, sh_basis_vjp

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


def _ewa_terms(means3d, cov3d_flat, camera: RenderCamera):
    """:func:`ewa_project`'s intermediates, in its operation order, for
    :func:`preprocess_vjp_plain`: the view-space ``tz`` (held at 1e-6 where
    ``z_held``: |t_z| < 1e-6), the tan-fov ratios ``ux``, ``uy``, their
    clamp's limits ``lim_x``, ``lim_y`` and clamped values ``cux``, ``cuy``,
    ``tx``, ``ty``, ``inv_z``, ``ex`` and ``ey`` (J's off-diagonal entries
    are ``ex * inv_z``, ``ey * inv_z``), M's rows ``m0``, ``m1``, ``s0`` =
    Sigma m0, ``s1`` = Sigma m1 and the covariance's entries ``cov00``,
    ``cov01``, ``cov11`` without the low-pass."""
    W = camera.world_view[:3, :3]
    ones = torch.ones_like(means3d[:, :1])
    t = (torch.cat([means3d, ones], dim=1) @ camera.world_view.T)[:, :3]
    # keep 1/z finite for culled/inactive points
    tz = t[:, 2]
    z_held = tz.abs() < 1e-6
    tz = torch.where(z_held, torch.full_like(tz, 1e-6), tz)
    lim_x = 1.3 * camera.tan_fov_x
    lim_y = 1.3 * camera.tan_fov_y
    ux, uy = t[:, 0] / tz, t[:, 1] / tz
    cux, cuy = torch.clamp(ux, -lim_x, lim_x), torch.clamp(uy, -lim_y, lim_y)
    tx = cux * tz
    ty = cuy * tz
    inv_z = 1.0 / tz
    a = camera.focal_x * inv_z  # (N,)
    b = camera.focal_y * inv_z
    ex = -camera.focal_x * tx * inv_z
    ey = -camera.focal_y * ty * inv_z
    c = ex * inv_z
    d = ey * inv_z

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
    return types.SimpleNamespace(
        tz=tz, z_held=z_held, lim_x=lim_x, lim_y=lim_y, ux=ux, uy=uy, cux=cux, cuy=cuy,
        tx=tx, ty=ty, inv_z=inv_z, ex=ex, ey=ey, m0=m0, m1=m1, s0=s0, s1=s1,
        cov00=m0[0] * s0[0] + m0[1] * s0[1] + m0[2] * s0[2],
        cov01=m0[0] * s1[0] + m0[1] * s1[1] + m0[2] * s1[2],
        cov11=m1[0] * s1[0] + m1[1] * s1[1] + m1[2] * s1[2])


def ewa_project(means3d, cov3d_flat, camera: RenderCamera):
    """EWA: 3D covariance -> 2D screen covariance (upper-left 2x2 of
    J W Sigma W^T J^T) with the +0.3 low-pass. Returns (N, 3) [xx, xy, yy].

    Scalar channels, as gsjax writes it: M = J @ W has rows
    m0 = fx/tz * W0 - fx tx/tz^2 * W2 and m1 = fy/tz * W1 - fy ty/tz^2 * W2."""
    e = _ewa_terms(means3d, cov3d_flat, camera)
    return torch.stack([e.cov00 + LOW_PASS, e.cov01, e.cov11 + LOW_PASS], dim=1)


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

    The version that runs is :func:`preprocess_path`'s pick."""
    cam = tuple(getattr(camera, k) for k in CAMERA_TENSORS)
    inputs = (means3d, scales, quats, opacities, shs, cov3d_precomp, colors_precomp,
              means2d_offset, *cam)
    wants_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)
    kernel_grads = (cov3d_precomp is None and colors_precomp is None
                    and not any(t.requires_grad for t in cam))
    fn = preprocess_path(means3d.device.type == "cuda", wants_grad, kernel_grads)
    return fn(means3d, scales, quats, opacities, shs, camera, sh_degree,
              scale_modifier=scale_modifier, cov3d_precomp=cov3d_precomp,
              colors_precomp=colors_precomp, active_mask=active_mask,
              means2d_offset=means2d_offset, opacity_aware_radius=opacity_aware_radius)


def preprocess_path(on_card: bool, wants_grad: bool, kernel_grads: bool):
    """The version :func:`preprocess` runs: :func:`preprocess_plain` for
    tensors off the card; on it :func:`preprocess_infer` where no gradient
    is wanted, :func:`preprocess_train` under autograd where the kernel's
    backward gives every gradient wanted (``kernel_grads``: no precomputed
    covariance or colors, no camera tensor that requires grad), else
    :func:`preprocess_plain` under autograd."""
    if not on_card:
        return preprocess_plain
    if not wants_grad:
        return preprocess_infer
    return preprocess_train if kernel_grads else preprocess_plain


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

    It launches through :func:`gsjax_torch.ops.kernels.launch`, which
    counts the kernels that ran as ``preprocess_infer``: a graphed frame's
    launch counts at its eager warm-up and at every replay, not at the
    capture."""
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
    k_used = min(k, (min(max(int(sh_degree), 0), 3) + 1) ** 2)
    kernels.launch("preprocess_infer", *ins, *out, n, k, k_used, camera.width, camera.height,
                   float(scale_modifier), int(bool(opacity_aware_radius)))
    return out


class _PreprocessTrain(torch.autograd.Function):
    """:func:`preprocess_plain` with one backward kernel: the forward runs
    the plain version with nothing recorded and saves only the inputs; the
    backward is :func:`preprocess_bwd`. Outputs are the fields of
    :class:`Splats` in order; depths and the integer fields carry no
    gradient."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, opacities, shs, means2d_offset, camera,
                sh_degree, scale_modifier, active_mask, opacity_aware_radius):
        out = preprocess_plain(means3d, scales, quats, opacities, shs, camera, sh_degree,
                               scale_modifier=scale_modifier, active_mask=active_mask,
                               means2d_offset=means2d_offset,
                               opacity_aware_radius=opacity_aware_radius)
        ctx.mark_non_differentiable(out.depths, out.radii, out.rect_min, out.rect_max,
                                    out.tiles_touched)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means3d, scales, quats, opacities, shs)
        ctx.camera, ctx.sh_degree, ctx.scale_modifier = camera, sh_degree, scale_modifier
        return tuple(out)

    @staticmethod
    def backward(ctx, d_means2d, _d_depths, d_conics, d_colors, d_opacities, *_ints):
        grads = preprocess_bwd(*ctx.saved_tensors, ctx.camera, ctx.sh_degree,
                               (d_means2d, d_conics, d_colors, d_opacities),
                               scale_modifier=ctx.scale_modifier,
                               with_offset=ctx.needs_input_grad[5])
        return (*grads, None, None, None, None, None)


def preprocess_train(
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
    """:func:`preprocess_plain`'s fields, bit for bit, with gradients to
    ``means3d``, ``scales``, ``quats``, ``opacities``, ``shs`` and
    ``means2d_offset`` from one launch of ``csrc/preprocess_bwd.cu``
    (:func:`preprocess_bwd`) in the backward. No gradient reaches the
    camera, and it takes no precomputed covariance or colors: those cases
    run the plain version under autograd (:func:`preprocess_path`)."""
    if cov3d_precomp is not None or colors_precomp is not None:
        raise ValueError("preprocess_train takes no precomputed covariance or colors")
    return Splats(*_PreprocessTrain.apply(
        means3d, scales, quats, opacities, shs, means2d_offset, camera, sh_degree,
        scale_modifier, active_mask, opacity_aware_radius))


def preprocess_bwd(means3d, scales, quats, opacities, shs, camera: RenderCamera,
                   sh_degree: int, grads, *, scale_modifier=1.0, with_offset=True):
    """The gradients of :func:`preprocess_plain`'s inputs from one launch of
    ``csrc/preprocess_bwd.cu`` on the current stream, for float32 CUDA
    tensors (the forward's inputs; ``shs`` (N, K, 3), K <= 16). ``grads``
    are the gradients of ``(means2d (N, 2), conics (N, 3), colors (N, 3),
    opacities (N,))``, each None (zero) or float32 rows of any stride (the
    reduction's column slices are read in place). Returns the gradients of
    ``(means3d, scales, quats, opacities, shs, means2d_offset)``, the last
    None unless ``with_offset``; the offset's is means2d's. It equals
    :func:`preprocess_vjp_plain` up to the order of its float32 sums.

    It launches through :func:`gsjax_torch.ops.kernels.launch`, which
    counts the kernels that ran as ``preprocess_bwd``, as
    :func:`preprocess_infer`'s."""
    dev = means3d.device
    if dev.type != "cuda":
        raise RuntimeError(f"preprocess_bwd runs on CUDA tensors, not {dev}")
    n = means3d.shape[0]
    k = shs.shape[1] if shs.dim() == 3 else 0
    if shs.shape[0] != n or k > 16 or shs.shape[-1] != 3:
        raise ValueError(f"shs must be (N, K <= 16, 3), got {tuple(shs.shape)}")

    def check(x):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"preprocess_bwd takes float32 tensors on {dev}, "
                             f"got {x.dtype} on {x.device}")
        return x

    def rows(g, width):  # (tensor, row stride in floats)
        if g is None:
            return None, 0
        g = check(g).reshape(n) if width == 1 else check(g).reshape(n, width)
        if width > 1 and g.stride(1) != 1:
            g = g.contiguous()
        return g, g.stride(0)

    ins = [check(x).reshape(n, *shape).contiguous() for x, shape in (
        (means3d, (3,)), (scales, (3,)), (quats, (4,)), (opacities, ()), (shs, (k, 3)))]
    ins += [check(getattr(camera, name)).reshape(-1).contiguous() for name in CAMERA_TENSORS]
    g_in = [rows(g, w) for g, w in zip(grads, (2, 3, 3, 1))]
    outs = [torch.empty((n, *shape), dtype=torch.float32, device=dev)
            for shape in ((3,), (3,), (4,), (), (k, 3), (2,))]
    if not with_offset:
        outs[5] = None
    k_used = min(k, (min(max(int(sh_degree), 0), 3) + 1) ** 2)
    kernels.launch("preprocess_bwd", *ins, *(g for g, _ in g_in), *(s for _, s in g_in), *outs,
                   n, k, k_used, camera.width, camera.height, float(scale_modifier))
    outs[3] = outs[3].reshape(opacities.shape)
    return tuple(outs)


def _f16_rounded(g, dtype):
    """``quantize_f16``'s backward on a gradient: rounded to float16 (as
    autograd's ``.to(float16)`` of it), in ``dtype``."""
    return g.to(torch.float16).to(dtype)


def preprocess_vjp_plain(means3d, scales, quats, opacities, shs, camera: RenderCamera,
                         sh_degree: int, grads, *, scale_modifier=1.0, with_offset=True):
    """:func:`preprocess_bwd`'s closed form in tensor ops, term by term, on
    any device and in float32 or float64 (a float64 camera with float64
    inputs): the gradients of ``(means3d, scales, quats, opacities, shs,
    means2d_offset)`` (the last None unless ``with_offset``) from those of
    ``(means2d, conics, colors, opacities)`` (each None for zero), as
    autograd gives them over :func:`preprocess_plain` with no precomputed
    covariance or colors. The masks read the forward's values from the
    plain version's own ops, so they agree with autograd's bit for bit."""
    n, dt, dev = means3d.shape[0], means3d.dtype, means3d.device

    def given(g, *shape, dtype=dt):
        return torch.zeros((n, *shape), dtype=dtype, device=dev) if g is None else g

    g_m2 = given(grads[0], 2)
    g_con = given(grads[1], 3)
    g_col = given(grads[2], 3, dtype=torch.float32)
    g_op = given(grads[3], dtype=torch.float32).reshape(n)
    zero = torch.zeros((), dtype=dt, device=dev)

    # opacities: quantize_f16 passes the f16-rounded gradient where it kept the value
    kept = quantize_f16(opacities.reshape(-1)) != 0.0
    d_op = torch.where(kept, _f16_rounded(g_op, opacities.dtype), zero.to(opacities.dtype))

    # projection: means2d = ((p_hom[:2] * p_w + 1) * size - 1) / 2 (+ offset)
    ones = torch.ones_like(means3d[:, :1])
    hom = torch.cat([means3d, ones], dim=1)
    p_hom = hom @ camera.full_proj.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    g_n0 = g_m2[:, 0] * 0.5 * camera.width
    g_n1 = g_m2[:, 1] * 0.5 * camera.height
    g_hom = torch.stack([g_n0 * p_w, g_n1 * p_w, torch.zeros_like(p_w),
                         -(g_n0 * p_hom[:, 0] + g_n1 * p_hom[:, 1]) * (p_w * p_w)], dim=1)
    d_m = (g_hom @ camera.full_proj)[:, :3]

    # the conic's inverse: conics = [c11, -c01, c00] / det where det > 0
    cov6 = covariance6(scales, quats, scale_modifier)
    e = _ewa_terms(means3d, cov6, camera)
    c00, c01, c11 = e.cov00 + LOW_PASS, e.cov01, e.cov11 + LOW_PASS
    det = c00 * c11 - c01 ** 2
    det_ok = det > 0.0
    sd = torch.where(det_ok, det, torch.ones_like(det))
    # where det > 0, d conic = -K dC K (K the conic as a symmetric 2x2 matrix):
    # d C = -K G K, G the conic's gradient as one (off-diagonal halved); it
    # does not cancel where the covariance is nearly axis-aligned, as
    # adj(C) / det's two terms do. Else conics = [c11, -c01, c00].
    ka, kb, kc = c11 / sd, -c01 / sd, c00 / sd
    h = 0.5 * g_con[:, 1]
    kg0, kg1 = ka * g_con[:, 0] + kb * h, ka * h + kb * g_con[:, 2]  # (K G) row 0
    kg2, kg3 = kb * g_con[:, 0] + kc * h, kb * h + kc * g_con[:, 2]  # (K G) row 1
    g00 = torch.where(det_ok, -(ka * kg0 + kb * kg1), g_con[:, 2])
    g01 = torch.where(det_ok, -2.0 * (kb * kg0 + kc * kg1), -g_con[:, 1])
    g11 = torch.where(det_ok, -(kb * kg2 + kc * kg3), g_con[:, 0])

    # EWA: cov00 = m0 . S m0, cov01 = m0 . S m1, cov11 = m1 . S m1
    S = [[cov6[:, j] for j in row] for row in ((0, 1, 2), (1, 3, 4), (2, 4, 5))]
    m0, m1, s0, s1 = e.m0, e.m1, e.s0, e.s1
    gs0 = [g00 * m0[c] for c in range(3)]
    gs1 = [g01 * m0[c] + g11 * m1[c] for c in range(3)]
    gm0 = [(g00 * s0[r] + g01 * s1[r]) + (S[r][0] * gs0[0] + S[r][1] * gs0[1] + S[r][2] * gs0[2])
           for r in range(3)]
    gm1 = [g11 * s1[r] + (S[r][0] * gs1[0] + S[r][1] * gs1[1] + S[r][2] * gs1[2])
           for r in range(3)]
    G = [[None] * 3 for _ in range(3)]  # d Sigma's stripped entries, as a symmetric matrix
    for r in range(3):
        for c in range(r, 3):
            g = gs0[r] * m0[c] + gs1[r] * m1[c]
            if c != r:
                g = g + gs0[c] * m0[r] + gs1[c] * m1[r]
            G[r][c] = G[c][r] = g
    W = camera.world_view
    g_a = sum(gm0[k] * W[0, k] for k in range(3))
    g_c = sum(gm0[k] * W[2, k] for k in range(3))
    g_b = sum(gm1[k] * W[1, k] for k in range(3))
    g_d = sum(gm1[k] * W[2, k] for k in range(3))
    fx, fy, inv_z = camera.focal_x, camera.focal_y, e.inv_z
    # c = ((-fx tx) inv_z) inv_z, d alike
    g_inv = (g_a * fx + g_b * fy + g_c * e.ex + (g_c * inv_z) * (-fx * e.tx)
             + g_d * e.ey + (g_d * inv_z) * (-fy * e.ty))
    g_tx = ((g_c * inv_z) * inv_z) * -fx
    g_ty = ((g_d * inv_z) * inv_z) * -fy
    g_tz = -g_inv * (inv_z * inv_z) + g_tx * e.cux + g_ty * e.cuy
    # the tan-fov clamp passes the ratio's gradient inside its limits only
    g_ux = torch.where((e.ux >= -e.lim_x) & (e.ux <= e.lim_x), g_tx * e.tz, zero)
    g_uy = torch.where((e.uy >= -e.lim_y) & (e.uy <= e.lim_y), g_ty * e.tz, zero)
    g_tz = g_tz - (g_ux * e.ux + g_uy * e.uy) / e.tz
    g_t = torch.stack([g_ux / e.tz, g_uy / e.tz, torch.where(e.z_held, zero, g_tz)], dim=1)
    d_m = d_m + g_t @ W[:3, :3]

    # covariance6: Sigma = R diag(s m)^2 R^T, R from safe_normalize(quats)
    rq = torch.rsqrt(torch.sum(quats * quats, dim=-1) + 1e-12 * 1e-12)
    w, x, y, z = (quats * rq[:, None]).unbind(-1)
    R = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    sm = scales * scale_modifier
    gR = [[None] * 3 for _ in range(3)]
    d_s = []
    for k in range(3):
        gr = [G[r][0] * R[0][k] + G[r][1] * R[1][k] + G[r][2] * R[2][k] + G[r][r] * R[r][k]
              for r in range(3)]
        for r in range(3):
            gR[r][k] = gr[r] * sm[:, k] ** 2
        g_u = 0.5 * (gr[0] * R[0][k] + gr[1] * R[1][k] + gr[2] * R[2][k])
        d_s.append(2.0 * sm[:, k] * g_u * scale_modifier)
    d_s = torch.stack(d_s, dim=1)
    gw = 2 * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] - x * gR[1][2] - y * gR[2][0]
              + x * gR[2][1])
    gx = 2 * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0] - 2 * x * gR[1][1] - w * gR[1][2]
              + z * gR[2][0] + w * gR[2][1] - 2 * x * gR[2][2])
    gy = 2 * (-2 * y * gR[0][0] + x * gR[0][1] + w * gR[0][2] + x * gR[1][0] + z * gR[1][2]
              - w * gR[2][0] + z * gR[2][1] - 2 * y * gR[2][2])
    gz = 2 * (-2 * z * gR[0][0] - w * gR[0][1] + x * gR[0][2] + w * gR[1][0] - 2 * z * gR[1][1]
              + y * gR[1][2] + x * gR[2][0] + y * gR[2][1])
    g_qh = torch.stack([gw, gx, gy, gz], dim=1)
    g_n2 = -0.5 * rq ** 3 * torch.sum(g_qh * quats, dim=1)
    d_q = g_qh * rq[:, None] + 2.0 * quats * g_n2[:, None]

    # colors: clamp_min(eval_sh(shs, dirs) + 0.5, 0), f16-quantized
    k = shs.shape[1]
    v = means3d - camera.camera_center[None, :]
    rv = torch.rsqrt(torch.sum(v * v, dim=-1) + 1e-12 * 1e-12)
    dirs = safe_normalize(v)
    col = eval_sh(shs, dirs, sh_degree) + 0.5
    kept = (col >= 0.0) & (quantize_f16(torch.clamp_min(col, 0.0)) != 0.0)
    g_raw = torch.where(kept, _f16_rounded(g_col, dt), zero)
    mask = band_mask(k, sh_degree, dt, dev)
    basis = sh_basis(dirs)[:, :k] * mask
    d_shs = basis[:, :, None] * g_raw[:, None, :]
    g_dir = sh_basis_vjp(dirs, torch.sum(shs * g_raw[:, None, :], dim=-1) * mask)
    g_nv = -0.5 * rv ** 3 * torch.sum(g_dir * v, dim=1)
    d_m = d_m + g_dir * rv[:, None] + 2.0 * v * g_nv[:, None]
    return (d_m, d_s, d_q, d_op.reshape(opacities.shape), d_shs,
            g_m2 if with_offset else None)
