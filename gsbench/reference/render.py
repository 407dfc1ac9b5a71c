"""The render, plainly: preprocess, pairs in depth order, the blend and its
backward, computed a chunk of pairs of many tiles at a time.

Semantics (gsjax's, which are the reference 3DGS rasterizer's):

- preprocess: activations, EWA projection with the +0.3 px low-pass,
  near cull at view z <= 0.2, 3-sigma radius, the opacity-aware binning
  radius ``min(3 sigma, sqrt(2 ln(255 op) lambda1) + 1)``, SH colors
  clamped at 0 after +0.5; colors and opacity rounded through float16
  (the kernels read them as f16 halves);
- pairs: every tile of a gaussian's binning rectangle, sorted by (tile,
  view depth truncated to the bits a uint32 key leaves beside the tile
  id, then the tie-break), where the tie-break is the gaussian's rank in
  (tiles touched, index) order for the compact and tiered expansions and
  its index for the plain grid;
- blend, per pixel at integer coordinates, front to back:
  ``alpha = min(0.99, op exp(power))``; a pair with ``power > 0`` or
  ``alpha < 1/255`` is skipped; a pair whose blend would take T below
  1e-4 ends the pixel, itself not blended; ``C += c alpha T``,
  ``T *= 1 - alpha``; the pixel is ``C + T bg``.

Whatever dtype the parameters come in is the dtype of the arithmetic, so
the same code, given bfloat16, is the control (``compare``).
"""

from __future__ import annotations

import dataclasses

import torch

TILE = 16
NEAR_CULL_Z = 0.2
LOW_PASS = 0.3
MIN_LAMBDA = 0.1
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
CHUNK = 32  # the fewest pairs of a tile a chunk takes
BLOCK_ELEMS = 1 << 25  # (tile, pair, pixel) elements of one chunk

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def num_tiles(width: int, height: int):
    return -(-width // TILE), -(-height // TILE)


def safe_normalize(x, eps=1e-12):
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps * eps)


def quantize_f16(x):
    """Nearest float16 value, subnormals flushed to 0, in ``x``'s dtype."""
    q = x.to(torch.float16).to(x.dtype)
    return torch.where(q.abs() < 2.0 ** -14, torch.zeros_like(q), q)


def activations(params: dict):
    """(means3d, scales, quats, opacities, shs) from the raw parameters."""
    scales = torch.exp(params["scaling"])
    quats = safe_normalize(params["rotation"])
    opac = torch.sigmoid(params["opacity"][:, 0])
    shs = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    return params["xyz"], scales, quats, opac, shs


def covariance6(scale, quat):
    """Sigma = (R S)(R S)^T as [xx, xy, xz, yy, yz, zz]."""
    q = safe_normalize(quat)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    u = [scale[:, 0] ** 2, scale[:, 1] ** 2, scale[:, 2] ** 2]

    def e(i, j):
        return r[i][0] * r[j][0] * u[0] + r[i][1] * r[j][1] * u[1] + r[i][2] * r[j][2] * u[2]

    return torch.stack([e(0, 0), e(0, 1), e(0, 2), e(1, 1), e(1, 2), e(2, 2)], dim=-1)


def sh_colors(shs, dirs, degree: int):
    """Degree-``degree`` real SH color (before the +0.5 offset)."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    one = torch.ones_like(x)
    basis = [SH_C0 * one, -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
             SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
             SH_C3[2] * y * (4.0 * zz - xx - yy), SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
             SH_C3[4] * x * (4.0 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
             SH_C3[6] * x * (xx - 3.0 * yy)]
    k = shs.shape[1]
    bands = [0] + [1] * 3 + [2] * 5 + [3] * 7
    b = torch.stack(basis[:k], dim=-1) * torch.tensor(
        [1.0 if bands[j] <= degree else 0.0 for j in range(k)], dtype=shs.dtype,
        device=shs.device)
    return torch.einsum("nk,nkc->nc", b, shs)


@dataclasses.dataclass
class Splats:
    means2d: torch.Tensor
    depths: torch.Tensor
    conics: torch.Tensor
    colors: torch.Tensor
    opacities: torch.Tensor
    radii: torch.Tensor  # int32, 0 where culled
    rect_min: torch.Tensor  # (N, 2) int64 binning rectangle, inclusive
    rect_max: torch.Tensor  # (N, 2) int64, exclusive
    tiles_touched: torch.Tensor  # (N,) int64


def preprocess(means3d, scales, quats, opac, shs, cam: dict, sh_degree: int, active,
               means2d_offset=None) -> Splats:
    """Per-gaussian screen-space splats, differentiable in the float
    outputs (the reference CUDA preprocess, forward.cu)."""
    dt = means3d.dtype
    W4 = cam["world_view"].to(dt)
    P4 = cam["full_proj"].to(dt)
    width, height = cam["width"], cam["height"]
    hom = torch.cat([means3d, torch.ones_like(means3d[:, :1])], dim=1)
    p_view = hom @ W4.T
    p_hom = hom @ P4.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    px = ((p_hom[:, 0] * p_w + 1.0) * width - 1.0) * 0.5
    py = ((p_hom[:, 1] * p_w + 1.0) * height - 1.0) * 0.5
    depths = p_view[:, 2]
    means2d = torch.stack([px, py], dim=1)
    if means2d_offset is not None:
        means2d = means2d + means2d_offset
    opac = quantize_f16(opac.reshape(-1))

    cov3 = covariance6(scales, quats)
    tan_x, tan_y = cam["tan_fov_x"].to(dt), cam["tan_fov_y"].to(dt)
    fx, fy = width / (2.0 * tan_x), height / (2.0 * tan_y)
    t = p_view[:, :3]
    tz = torch.where(t[:, 2].abs() < 1e-6, torch.full_like(t[:, 2], 1e-6), t[:, 2])
    tx = torch.clamp(t[:, 0] / tz, -1.3 * tan_x, 1.3 * tan_x) * tz
    ty = torch.clamp(t[:, 1] / tz, -1.3 * tan_y, 1.3 * tan_y) * tz
    inv_z = 1.0 / tz
    a, b = fx * inv_z, fy * inv_z
    c, d = -fx * tx * inv_z * inv_z, -fy * ty * inv_z * inv_z
    Wr = W4[:3, :3]
    m0 = [a * Wr[0, k] + c * Wr[2, k] for k in range(3)]
    m1 = [b * Wr[1, k] + d * Wr[2, k] for k in range(3)]
    sxx, sxy, sxz, syy, syz, szz = (cov3[:, i] for i in range(6))

    def sig(v):
        return (sxx * v[0] + sxy * v[1] + sxz * v[2], sxy * v[0] + syy * v[1] + syz * v[2],
                sxz * v[0] + syz * v[1] + szz * v[2])

    s0, s1 = sig(m0), sig(m1)
    c00 = m0[0] * s0[0] + m0[1] * s0[1] + m0[2] * s0[2] + LOW_PASS
    c01 = m0[0] * s1[0] + m0[1] * s1[1] + m0[2] * s1[2]
    c11 = m1[0] * s1[0] + m1[1] * s1[1] + m1[2] * s1[2] + LOW_PASS
    det = c00 * c11 - c01 ** 2
    det_ok = det > 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    conics = torch.stack([c11, -c01, c00], dim=1) / safe_det[:, None]
    mid = 0.5 * (c00 + c11)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, MIN_LAMBDA))
    radii_f = torch.ceil(3.0 * torch.sqrt(lambda1))
    valid = (depths > NEAR_CULL_Z) & det_ok & active
    tiles_x, tiles_y = num_tiles(width, height)

    def rects(r):
        with torch.no_grad():
            lo = torch.stack([torch.clamp(torch.floor((means2d[:, 0] - r) / TILE), 0, tiles_x),
                              torch.clamp(torch.floor((means2d[:, 1] - r) / TILE), 0, tiles_y)],
                             dim=1).to(torch.int64)
            hi = torch.stack([
                torch.clamp(torch.floor((means2d[:, 0] + r + TILE - 1) / TILE), 0, tiles_x),
                torch.clamp(torch.floor((means2d[:, 1] + r + TILE - 1) / TILE), 0, tiles_y)],
                dim=1).to(torch.int64)
        return lo, hi, (hi[:, 0] - lo[:, 0]) * (hi[:, 1] - lo[:, 1])

    _, _, tiles3 = rects(radii_f)
    valid = valid & (tiles3 > 0)
    radii = torch.where(valid, radii_f, torch.zeros_like(radii_f)).to(torch.int32)
    with torch.no_grad():
        chi = 2.0 * torch.log(255.0 * torch.clamp_min(opac, 1e-12))
        r_bin = torch.minimum(radii_f, torch.ceil(torch.sqrt(torch.clamp_min(chi, 0.0)
                                                             * lambda1)) + 1.0)
    rect_min, rect_max, tiles_bin = rects(r_bin)
    touched = torch.where(valid & (chi > 0.0), tiles_bin, torch.zeros_like(tiles_bin))

    dirs = safe_normalize(means3d - cam["camera_center"].to(dt)[None, :])
    colors = quantize_f16(torch.clamp_min(sh_colors(shs, dirs, sh_degree) + 0.5, 0.0))
    return Splats(means2d, depths, conics, colors, opac, radii, rect_min, rect_max, touched)


def depth_bits(n_tiles: int) -> int:
    """Depth bits beside the tile id in a uint32 key (the id and its
    sentinel ``n_tiles`` take the rest)."""
    return 32 - max(int(n_tiles + 1).bit_length(), 1)


@torch.no_grad()
def pairs(sp: Splats, width: int, height: int, tie: str):
    """Every (gaussian, tile) pair of the binning rectangles, in blend
    order: ``(pair_gauss (P,) int64, tile_start (T + 1,) int64)``.
    ``tie``: "count_index" (compact and tiered expansions) or "index"
    (the plain grid)."""
    dev = sp.depths.device
    tiles_x, tiles_y = num_tiles(width, height)
    n_t = tiles_x * tiles_y
    n = sp.depths.shape[0]
    count = sp.tiles_touched
    idx = torch.arange(n, device=dev)
    if tie == "count_index":
        rows = torch.sort(count * n + idx).indices
    elif tie == "index":
        rows = idx
    else:
        raise ValueError(f"unknown tie-break {tie!r}")
    rows = rows[count[rows] > 0]
    cnt = count[rows]
    g = torch.repeat_interleave(rows, cnt)
    first = torch.cumsum(cnt, 0) - cnt
    j = torch.arange(g.shape[0], device=dev) - torch.repeat_interleave(first, cnt)
    w = torch.clamp_min(sp.rect_max[g, 0] - sp.rect_min[g, 0], 1)
    tile = (sp.rect_min[g, 1] + j // w) * tiles_x + sp.rect_min[g, 0] + j % w
    bits = depth_bits(n_t)
    d = torch.clamp_min(sp.depths.detach().to(torch.float32), 0.0) + 0.0
    dq = (d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) >> (31 - bits)
    key = (tile << bits) | dq[g]
    order = torch.sort(key, stable=True).indices
    tile_s = tile[order]
    start = torch.searchsorted(tile_s, torch.arange(n_t + 1, device=dev))
    return g[order], start


def _tile_pixels(tiles, tiles_x, dtype):
    """(B, 256) pixel x and y of tiles ``tiles`` (B,)."""
    p = torch.arange(TILE * TILE, device=tiles.device)
    x = (tiles % tiles_x)[:, None] * TILE + (p % TILE)[None, :]
    y = (tiles // tiles_x)[:, None] * TILE + (p // TILE)[None, :]
    return x.to(dtype), y.to(dtype)


def _chunk_alpha(px, py, m, c, op):
    """Alpha and the power of a chunk: (B, K, 256) from (B, K, .) pairs and
    (B, 256) pixels. The pixel axis is innermost, so the scans over the
    pairs run down an outer axis."""
    dx = px[:, None, :] - m[:, :, 0, None]
    dy = py[:, None, :] - m[:, :, 1, None]
    power = (-0.5 * (c[:, :, 0, None] * dx * dx + c[:, :, 2, None] * dy * dy)
             - c[:, :, 1, None] * dx * dy)
    alpha = torch.clamp_max(op[:, :, None] * torch.exp(power), ALPHA_MAX)
    return alpha, power


def _chunk_blend(alpha, power, live, T_in, done_in):
    """The frozen blend of a chunk given each pixel's T and end flag on
    entry: ``(alpha_eff, T before each pair, T after the chunk, ended,
    blended)``. Which pairs blend is decided on detached values with the
    sequential product; the transmittances are ``exp`` of a running sum of
    ``log(1 - alpha)``, whose gradient is a plain reversed sum."""
    with torch.no_grad():
        ok = live[:, :, None] & (power <= 0.0) & (alpha >= ALPHA_MIN) & ~done_in[:, None, :]
        one_m = torch.where(ok, 1.0 - alpha, torch.ones_like(alpha))
        t_inc = T_in[:, None, :] * torch.cumprod(one_m, dim=1)
        trip = ok & (t_inc < T_EPS)
        ended = torch.cumsum(trip.to(torch.int32), dim=1) > 0
        keep = ok & ~ended
    a = torch.where(keep, alpha, torch.zeros_like(alpha))
    log_m = torch.log1p(-a)
    cs = torch.cumsum(log_m, dim=1)
    t_ex = T_in[:, None, :] * torch.exp(cs - log_m)
    return a, t_ex, T_in * torch.exp(cs[:, -1, :]), ended[:, -1, :], keep


def _chunk_grads(px, py, m, c, col, op, live, T_in, done_in, g_col, g_T):
    """The gradients of one chunk, written out: of its pairs' means (B, K,
    2), conics (B, K, 3), colors (B, K, 3) and opacities (B, K), and of
    each pixel's T on entry (B, 256), from the loss's gradients of the
    pixels' colors ``g_col`` (B, 256, 3) and of their T after the chunk
    ``g_T`` (B, 256). With ``w_k = a_k T_k`` and ``g_k = c_k . g_col``:
    ``dL/da_k = T_k g_k - S_k / (1 - a_k)``, ``S_k`` the sum over the
    pairs behind ``k`` of ``w_j g_j`` plus ``T_out g_T``; past the 0.99
    clamp alpha no longer moves with opacity or power."""
    alpha, power = _chunk_alpha(px, py, m, c, op)
    a, t_ex, t_out, _, keep = _chunk_blend(alpha, power, live, T_in, done_in)
    g = torch.einsum("bkc,bpc->bkp", col, g_col)
    w = a * t_ex
    x = w * g
    total = x.sum(dim=1, keepdim=True)
    tail = t_out[:, None, :] * g_T[:, None, :]
    behind = total - torch.cumsum(x, dim=1) + tail
    d_a = torch.where(keep, t_ex * g - behind / (1.0 - a), torch.zeros_like(a))
    raw = op[:, :, None] * torch.exp(power)
    d_raw = torch.where(raw <= ALPHA_MAX, d_a, torch.zeros_like(d_a))
    d_op = (d_raw * torch.exp(power)).sum(-1)
    d_pow = d_raw * raw
    dx = px[:, None, :] - m[:, :, 0, None]
    dy = py[:, None, :] - m[:, :, 1, None]
    d_c = torch.stack([(d_pow * dx * dx).sum(-1) * -0.5, -(d_pow * dx * dy).sum(-1),
                       (d_pow * dy * dy).sum(-1) * -0.5], dim=-1)
    d_dx = d_pow * (-c[:, :, 0, None] * dx - c[:, :, 1, None] * dy)
    d_dy = d_pow * (-c[:, :, 2, None] * dy - c[:, :, 1, None] * dx)
    d_m = torch.stack([-d_dx.sum(-1), -d_dy.sum(-1)], dim=-1)
    d_col = torch.einsum("bkp,bpc->bkc", w, g_col)
    d_T = (total[:, 0, :] + t_out * g_T) / torch.clamp_min(T_in, 1e-30)
    return d_m, d_c, d_col, d_op, d_T


class Blend:
    """The blend of one frame: :meth:`forward` gives the tiles' colors and
    T and keeps, for each chunk of pairs, each pixel's T and end flag on
    entry; :meth:`backward` replays the chunks back to front with
    autograd, one chunk at a time, and gives the gradients of the
    per-gaussian 2D attributes. ``blended`` counts the (pair, pixel)
    steps that changed the result (blended in the forward; the same set
    contributes in the backward).

    Tiles are taken deepest first: a chunk takes pairs ``[k0, k0 + K)``
    of the tiles that have pairs at depth ``k0`` and a pixel not yet
    ended, ``K`` grown as those tiles become fewer, so that no chunk
    holds much more than ``BLOCK_ELEMS`` (tile, pair, pixel) elements."""

    def __init__(self, pair_gauss, tile_start, means2d, conics, colors, opac,
                 width: int, height: int):
        self.pg, self.ts = pair_gauss, tile_start
        self.attrs = (means2d.detach(), conics.detach(), colors.detach(), opac.detach())
        self.tiles_x, self.tiles_y = num_tiles(width, height)
        self.dtype = means2d.dtype
        n_t = self.tiles_x * self.tiles_y
        count = (tile_start[1:] - tile_start[:-1])[:n_t]
        self.order = torch.sort(count, descending=True, stable=True).indices
        self.count = count[self.order]  # descending
        self.count_host = self.count.tolist()
        self.saved = []
        self.blended = 0

    def _live(self, k0: int) -> int:
        """How many tiles (a prefix of the order) have a pair at depth k0."""
        lo, hi = 0, len(self.count_host)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.count_host[mid] > k0:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _gather(self, pos, k0: int, K: int):
        """Pairs ``[k0, k0 + K)`` of the tiles at positions ``pos`` of the
        order: ``(gaussian (B, K), live (B, K))``, 0 where a tile has fewer."""
        dev = self.pg.device
        k = k0 + torch.arange(K, device=dev)
        live = k[None, :] < self.count[pos][:, None]
        pidx = self.ts[self.order[pos]][:, None] + k[None, :]
        pidx = torch.clamp(pidx, max=max(self.pg.shape[0] - 1, 0))
        g = torch.where(live, self.pg[pidx], 0) if self.pg.numel() else torch.zeros_like(pidx)
        return g, live

    @torch.no_grad()
    def forward(self):
        """A chunk takes the tiles that still have pairs at its depth and a
        pixel that has not ended; a tile whose every pixel has ended adds
        nothing more and is left out."""
        n_t = self.tiles_x * self.tiles_y
        dev, dt = self.pg.device, self.dtype
        m, c, col, op = self.attrs
        px, py = _tile_pixels(self.order, self.tiles_x, dt)
        T = torch.ones((n_t, TILE * TILE), dtype=dt, device=dev)
        done = torch.zeros_like(T, dtype=torch.bool)
        acc = torch.zeros((n_t, TILE * TILE, 3), dtype=dt, device=dev)
        self.blended = 0
        self.saved = []
        k0 = 0
        while True:
            n = self._live(k0)
            if n == 0:
                break
            pos = torch.nonzero(~done[:n].all(dim=1)).reshape(-1)
            if pos.numel() == 0:
                break
            depth = int(self.count[pos].max())
            K = min(max(CHUNK, BLOCK_ELEMS // (pos.numel() * TILE * TILE)), depth - k0)
            g, live = self._gather(pos, k0, K)
            alpha, power = _chunk_alpha(px[pos], py[pos], m[g], c[g], op[g])
            T_in, done_in = T[pos], done[pos]
            a, t_ex, t_out, end, keep = _chunk_blend(alpha, power, live, T_in, done_in)
            self.saved.append((k0, K, pos, T_in, done_in))
            acc[pos] += torch.einsum("bkp,bkc->bpc", a * t_ex, col[g])
            self.blended += int(keep.sum())
            T[pos] = t_out
            done[pos] = done_in | end
            k0 += K
        colors = torch.empty_like(acc)
        colors[self.order] = acc
        T_out = torch.empty_like(T)
        T_out[self.order] = T
        return colors, T_out

    @torch.no_grad()
    def backward(self, d_colors, d_T):
        """Gradients of the 2D attributes, from those of the tiles' colors
        (T, 256, 3) and T (T, 256): the chunks back to front
        (:func:`_chunk_grads`)."""
        m, c, col, op = self.attrs
        grads = [torch.zeros_like(x) for x in self.attrs]
        px, py = _tile_pixels(self.order, self.tiles_x, self.dtype)
        gc = d_colors[self.order]
        gT = d_T[self.order].clone()  # of the T leaving the last chunk
        for k0, K, pos, T_in, done_in in reversed(self.saved):
            g, live = self._gather(pos, k0, K)
            out = _chunk_grads(px[pos], py[pos], m[g], c[g], col[g], op[g], live, T_in,
                               done_in, gc[pos], gT[pos])
            for acc, leaf_grad in zip(grads, out[:4]):
                acc.index_add_(0, g.reshape(-1), leaf_grad.reshape((-1,) + acc.shape[1:]))
            gT[pos] = out[4]
        self.saved = []
        return grads


def assemble(tile_colors, tile_T, bg, width: int, height: int):
    """Tiles (T, 256, 3) and (T, 256) to the (H, W, 3) image ``C + T bg``."""
    tiles_x, tiles_y = num_tiles(width, height)
    img = tile_colors + tile_T[..., None] * bg.to(tile_colors.dtype)[None, None, :]
    img = img.reshape(tiles_y, tiles_x, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(tiles_y * TILE, tiles_x * TILE, 3)[:height, :width]


def quantize_u8(img):
    """A [0, 1] image as uint8, rounding half up (the served frame's)."""
    return torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


@torch.no_grad()
def render(params: dict, active, cam: dict, bg, sh_degree: int, tie: str):
    """One frame: ``(image (H, W, 3), blended (pair, pixel) steps, pairs,
    radii)``."""
    sp = preprocess(*activations(params), cam, sh_degree, active)
    pg, ts = pairs(sp, cam["width"], cam["height"], tie)
    blend = Blend(pg, ts, sp.means2d, sp.conics, sp.colors, sp.opacities,
                  cam["width"], cam["height"])
    tc, tT = blend.forward()
    blend.saved = []
    return (assemble(tc, tT, bg, cam["width"], cam["height"]), blend.blended,
            int(pg.shape[0]), sp.radii)
