"""A benchmark-scale photometric COLMAP scene, generated from a seed: the
port's copy of ``scripts/make_synthetic_scene.py``, rendered through the
port (``make_render_fn``) and written with the port's COLMAP writers.

The scene is Garden-class in structure: a textured ground disk plus
textured solids (spheres, torus, box) built from ~250k surface-aligned
flat Gaussians with procedural multi-frequency textures, rendered from an
orbit ring of cameras. Output is the standard COLMAP layout
(``sparse/0/{cameras,images,points3D}.bin`` + ``images/*.png``), so
``python -m gsjax_torch.train -s <dir> --eval`` consumes it like a real
capture (reference scene/dataset_readers.py readColmapSceneInfo). The
sparse init is an SfM-like subsample: jittered surface points with noisy
colors, so training must densify to fit the texture detail.

Usage:
    python -m gsjax_torch.synthetic_scene out_dir \
        [--n_gauss 250000] [--n_views 120] [--width 800] [--height 800]
        [--n_sparse 30000] [--seed 0] [--device cuda]

The GT model, the cameras and the sparse points are the numpy of the
script, draw for draw; the images come from the port's renderer, with
the script's budgets grown until no view drops a pair.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from gsjax_torch.utils.sh import rgb_to_sh

FOV_X = 1.1  # every camera's horizontal field of view, radians


# ---------------------------------------------------------------------------
# procedural textures: multi-frequency color fields over 3D points
# ---------------------------------------------------------------------------


def _tex_checker(p, scale, c0, c1):
    m = (np.floor(p[:, 0] * scale) + np.floor(p[:, 1] * scale)) % 2
    return np.where(m[:, None] > 0.5, c1, c0)


def _tex_waves(p, freqs, phases, palette):
    """Smooth multi-frequency field: sum of sinusoids -> palette blend."""
    t = np.zeros(len(p))
    for (fx, fy, fz), ph in zip(freqs, phases):
        t += np.sin(fx * p[:, 0] + fy * p[:, 1] + fz * p[:, 2] + ph)
    t = (t / len(freqs) + 1.0) / 2.0  # [0, 1]
    idx = np.clip(t * (len(palette) - 1), 0, len(palette) - 1.001)
    lo = idx.astype(int)
    frac = (idx - lo)[:, None]
    pal = np.asarray(palette)
    return pal[lo] * (1 - frac) + pal[lo + 1] * frac


def _quats_from_rotmats(R):
    """Vectorized rotation-matrix -> quaternion (w,x,y,z), Shepperd-style:
    pick the numerically largest of the four squared components per row
    (the per-row loop version in data.colmap is fine for camera counts
    but not for millions of splats)."""
    m00, m01, m02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    m10, m11, m12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    m20, m21, m22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
    tr = m00 + m11 + m22
    qw2 = np.maximum(1 + tr, 0)
    qx2 = np.maximum(1 + m00 - m11 - m22, 0)
    qy2 = np.maximum(1 - m00 + m11 - m22, 0)
    qz2 = np.maximum(1 - m00 - m11 + m22, 0)
    cand = np.stack([qw2, qx2, qy2, qz2], axis=1)
    best = np.argmax(cand, axis=1)
    s = 0.5 * np.sqrt(np.maximum(cand[np.arange(len(R)), best], 1e-12))
    inv = 1.0 / (4 * s)
    # all four branch layouts evaluated full-length, then row-selected
    branches = np.stack([
        np.stack([s, (m21 - m12) * inv, (m02 - m20) * inv,
                  (m10 - m01) * inv], 1),
        np.stack([(m21 - m12) * inv, s, (m01 + m10) * inv,
                  (m02 + m20) * inv], 1),
        np.stack([(m02 - m20) * inv, (m01 + m10) * inv, s,
                  (m12 + m21) * inv], 1),
        np.stack([(m10 - m01) * inv, (m02 + m20) * inv,
                  (m12 + m21) * inv, s], 1),
    ])  # (4, N, 4)
    q = branches[best, np.arange(len(R))]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def _tangent_quats(normals, rng):
    """Quaternions (w,x,y,z) whose local z-axis == the surface normal, with
    a random in-plane spin (so flat gaussians lie in the surface)."""
    n = normals / np.linalg.norm(normals, axis=1, keepdims=True)
    # pick any tangent
    a = np.where(
        np.abs(n[:, 2:3]) < 0.9,
        np.tile([0.0, 0.0, 1.0], (len(n), 1)),
        np.tile([1.0, 0.0, 0.0], (len(n), 1)),
    )
    t = np.cross(a, n)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    b = np.cross(n, t)
    spin = rng.uniform(0, 2 * np.pi, len(n))
    cs, sn = np.cos(spin)[:, None], np.sin(spin)[:, None]
    t2 = t * cs + b * sn
    b2 = -t * sn + b * cs
    R = np.stack([t2, b2, n], axis=2)  # columns = local axes
    return _quats_from_rotmats(R)


def _value_noise(p, freq, seed):
    """3D value noise via a hashed integer lattice + trilinear blend —
    cheap per-point high-frequency texture (no lattice array needed)."""
    q = p * freq
    q0 = np.floor(q).astype(np.int64)
    f = q - q0
    f = f * f * (3 - 2 * f)  # smoothstep

    def h(c):
        x = (c[:, 0] * 374761393 + c[:, 1] * 668265263
             + c[:, 2] * 2147483647 + np.int64(seed) * 144665) & 0x7FFFFFFF
        x = (x ^ (x >> 13)) * 1274126177 & 0x7FFFFFFF
        return ((x ^ (x >> 16)) & 0xFFFF).astype(np.float64) / 65535.0

    acc = np.zeros(len(p))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                acc += w * h(q0 + np.array([dx, dy, dz], np.int64))
    return acc  # [0, 1]


def _hf_detail(p, seed, octaves=((24.0, 0.5), (61.0, 0.3), (149.0, 0.2))):
    """Multi-octave per-channel value noise in [-1, 1]^3 — the texture
    content that forces densification to keep splats small (a smooth-only
    GT collapses to a few thousand wide splats; see r3 evidence)."""
    out = np.zeros((len(p), 3))
    for ch in range(3):
        v = np.zeros(len(p))
        for i, (freq, amp) in enumerate(octaves):
            v += amp * (_value_noise(p, freq, seed + 97 * ch + 13 * i) - 0.5)
        out[:, ch] = v
    return 2.0 * out


def _structured_detail(
    p, seed,
    octaves=((1.6, 0.45), (4.0, 0.32), (10.0, 0.22), (26.0, 0.14)),
    levels=4,
):
    """Quantized multi-scale value noise in ~[-0.5, 0.5]^3: flat color
    patches with SHARP boundaries at every octave — photo-like structure.

    Why this exists (VERDICT r4 missing #4): the white-noise-only
    ``_hf_detail`` texture produced a scene whose densification *shrank*
    the model 250k -> 106k. Zero-mean isotropic noise gives a wide splat
    balanced pulls — the net position gradient, the sole densify trigger
    (reference scene/gaussian_model.py:405-407, threshold 2e-4 on
    ||d mean2D||), cancels, so clone/split never fires and opacity pruning
    wins. Real photos have a ~1/f spectrum with edges at all scales:
    coarse structure drives large coherent position gradients that split
    big splats, then progressively finer edges keep triggering as the
    splats shrink — the 30-40x growth real scenes show. Quantizing value
    noise into ``levels`` flat bands reproduces exactly that: region
    boundaries are step edges (all frequencies), amplitudes fall off with
    frequency (pink-ish spectrum)."""
    out = np.zeros((len(p), 3))
    for i, (freq, amp) in enumerate(octaves):
        for ch in range(3):
            v = _value_noise(p, freq, seed + 31 * i + 97 * ch)
            lev = np.floor(
                np.clip(v, 0.0, 0.999) * levels
            ) / (levels - 1.0) - 0.5
            out[:, ch] += amp * lev
    return out


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------


def _disk(n, rng, z=-0.8, radius=4.0):
    r = radius * np.sqrt(rng.uniform(0, 1, n))
    th = rng.uniform(0, 2 * np.pi, n)
    pts = np.stack([r * np.cos(th), r * np.sin(th), np.full(n, z)], axis=1)
    normals = np.tile([0.0, 0.0, 1.0], (n, 1))
    area = np.pi * radius**2
    colors = 0.6 * _tex_checker(pts, 1.25, [0.45, 0.35, 0.25], [0.25, 0.3, 0.2])
    colors += 0.4 * _tex_waves(
        pts, [(3.1, 1.7, 0.0), (7.3, 5.1, 0.0), (13.7, 11.1, 0.0)],
        [0.0, 1.3, 2.9],
        [[0.2, 0.15, 0.1], [0.5, 0.45, 0.3], [0.35, 0.4, 0.3], [0.6, 0.55, 0.5]],
    )
    return pts, normals, colors, area


def _sphere(n, rng, center, radius, palette, freqs):
    v = rng.normal(0, 1, (n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = np.asarray(center) + radius * v
    area = 4 * np.pi * radius**2
    colors = _tex_waves(
        pts - center, freqs, [0.0, 1.1, 2.2], palette
    )
    return pts, v, colors, area


def _torus(n, rng, center, R, r, palette):
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    cu, su, cv, sv = np.cos(u), np.sin(u), np.cos(v), np.sin(v)
    pts = np.stack(
        [(R + r * cv) * cu, (R + r * cv) * su, r * sv], axis=1
    ) + np.asarray(center)
    normals = np.stack([cv * cu, cv * su, sv], axis=1)
    area = 4 * np.pi**2 * R * r
    stripes = _tex_checker(np.stack([u * 2, v * 2], 1) / np.pi, 1.0,
                           palette[0], palette[1])
    return pts, normals, stripes, area


def _box(n, rng, center, half, palette):
    face = rng.integers(0, 6, n)
    uv = rng.uniform(-1, 1, (n, 2))
    pts = np.zeros((n, 3))
    normals = np.zeros((n, 3))
    areas = np.zeros(3)
    h = np.asarray(half)
    for f in range(6):
        ax = f // 2
        sgn = 1.0 if f % 2 == 0 else -1.0
        m = face == f
        others = [i for i in range(3) if i != ax]
        pts[m, ax] = sgn * h[ax]
        pts[m, others[0]] = uv[m, 0] * h[others[0]]
        pts[m, others[1]] = uv[m, 1] * h[others[1]]
        normals[m, ax] = sgn
    pts += np.asarray(center)
    area = 8 * (h[0] * h[1] + h[1] * h[2] + h[0] * h[2])
    colors = _tex_waves(
        pts - center, [(9.0, 2.0, 4.0), (2.0, 11.0, 3.0)], [0.4, 2.0], palette
    )
    return pts, normals, colors, area


def build_gt_model(n_total: int, seed: int = 0, hf_amp: float = 0.0,
                   coverage: float = 2.0, structure_amp: float = 0.0,
                   hf_octaves=None):
    """Assemble the GT gaussian set (post-activation arrays).

    ``hf_amp`` > 0 overlays multi-octave value noise on every surface
    color — high-frequency detail that a trained model can only fit with
    ~GT-density small splats (the lever that controls final trained N;
    the smooth default collapses to a few thousand wide splats).
    ``structure_amp`` > 0 additionally overlays :func:`_structured_detail`
    — sharp-edged multi-scale patches whose coherent position gradients
    keep clone/split firing (the growth trigger white noise lacks; see
    that function's docstring). ``coverage`` scales the per-splat
    footprint (sigma multiplier over the sqrt-area-share baseline)."""
    rng = np.random.default_rng(seed)
    specs = [
        lambda n: _disk(n, rng),
        lambda n: _sphere(
            n, rng, [0.0, 0.0, 0.2], 1.0,
            [[0.7, 0.2, 0.15], [0.85, 0.6, 0.2], [0.9, 0.85, 0.7]],
            [(6.0, 6.0, 6.0), (15.0, 4.0, 9.0), (25.0, 21.0, 14.0)],
        ),
        lambda n: _sphere(
            n, rng, [1.8, 1.2, -0.3], 0.5,
            [[0.15, 0.3, 0.6], [0.4, 0.65, 0.8], [0.8, 0.9, 0.95]],
            [(11.0, 7.0, 5.0), (23.0, 17.0, 2.0)],
        ),
        lambda n: _sphere(
            n, rng, [-1.6, 1.5, -0.35], 0.45,
            [[0.2, 0.5, 0.2], [0.5, 0.7, 0.3], [0.9, 0.9, 0.6]],
            [(9.0, 13.0, 6.0), (19.0, 3.0, 15.0)],
        ),
        lambda n: _torus(
            n, rng, [-1.2, -1.6, -0.55], 0.7, 0.22,
            [[0.6, 0.3, 0.6], [0.9, 0.8, 0.3]],
        ),
        lambda n: _box(
            n, rng, [1.4, -1.5, -0.45], [0.4, 0.4, 0.35],
            [[0.55, 0.25, 0.1], [0.8, 0.5, 0.25], [0.95, 0.8, 0.55]],
        ),
    ]
    # probe areas with tiny samples, then allocate n proportional to area
    probes = [s(16) for s in specs]
    areas = np.asarray([p[3] for p in probes])
    weights = areas / areas.sum()
    counts = np.maximum((weights * n_total).astype(int), 1000)

    pts_l, nrm_l, col_l, scl_l = [], [], [], []
    for s, cnt, area in zip(specs, counts, areas):
        p, n, c, _ = s(int(cnt))
        if structure_amp > 0.0:
            c = c + structure_amp * _structured_detail(p, seed + 5)
        if hf_amp > 0.0:
            c = c + hf_amp * _hf_detail(
                p, seed + 7,
                **({"octaves": hf_octaves} if hf_octaves else {}),
            )
        pts_l.append(p)
        nrm_l.append(n)
        col_l.append(np.clip(c, 0.02, 0.98))
        # coverage-complete footprint: ~sqrt(area per splat) x overlap
        sigma = coverage * np.sqrt(area / cnt)
        scl_l.append(np.full((int(cnt),), sigma))
    pts = np.concatenate(pts_l).astype(np.float32)
    nrm = np.concatenate(nrm_l).astype(np.float32)
    col = np.concatenate(col_l).astype(np.float32)
    sig = np.concatenate(scl_l).astype(np.float32)

    n = len(pts)
    scales = np.stack([sig, sig, sig * 0.1], axis=1)  # flat along the normal
    scales *= np.exp(rng.normal(0, 0.15, (n, 3))).astype(np.float32)
    quats = _tangent_quats(nrm, rng).astype(np.float32)
    opac = rng.uniform(0.75, 0.98, n).astype(np.float32)

    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rgb_to_sh(col)
    # mild view dependence on the degree-1 bands (specular-ish sheen)
    shs[:, 1:4] = rng.normal(0, 0.04, (n, 3, 3)).astype(np.float32)
    return pts, scales, quats, opac, shs, col


# ---------------------------------------------------------------------------
# cameras, rendering, COLMAP output
# ---------------------------------------------------------------------------


def ring_c2w_opengl(radius, azimuth, elevation=0.35):
    """Camera-to-world (OpenGL: Y up, Z back) on a ring looking at origin."""
    p = np.array([
        radius * np.cos(azimuth) * np.cos(elevation),
        radius * np.sin(azimuth) * np.cos(elevation),
        radius * np.sin(elevation),
    ])
    fwd = -p / np.linalg.norm(p)  # toward origin
    z = -fwd  # OpenGL camera looks along -z
    up = np.array([0.0, 0.0, 1.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, p
    return c2w


def camera_from_c2w(c2w_gl, fov_x, width, height, uid, name):
    from gsjax_torch.data.cameras import Camera

    c2w = c2w_gl.copy()
    c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP
    w2c = np.linalg.inv(c2w)
    fov_y = 2 * np.arctan(np.tan(fov_x / 2) * height / width)
    return Camera(
        uid=uid, image_name=name, R=w2c[:3, :3].T, T=w2c[:3, 3],
        fov_x=fov_x, fov_y=fov_y, width=width, height=height,
    )


def make_cameras(n_views, width, height, seed, preset=None):
    """Two orbit rings (low and high elevation), all looking at the origin."""
    cams = []
    rng = np.random.default_rng(seed + 1)
    for i in range(n_views):
        ring = i % 2
        az = 2 * np.pi * i / n_views + rng.normal(0, 0.02)
        if preset == "garden_growth2":
            # dome-like rig: both rings high enough that the closest
            # content distance stays within ~1.3x of the mean
            elev = (0.5 if ring == 0 else 0.75) + rng.normal(0, 0.03)
        else:
            elev = (0.28 if ring == 0 else 0.55) + rng.normal(0, 0.03)
        radius = 7.0 + rng.normal(0, 0.15)
        cams.append(camera_from_c2w(ring_c2w_opengl(radius, az, elev), FOV_X, width, height,
                                    i, f"{i:04d}.png"))
    return cams


def gt_state(pts, scales, quats, opac, shs, device):
    """The GT gaussians as a model state (pre-activation parameters)."""
    import torch

    from gsjax_torch.models.gaussians import state_from_numpy

    n = len(pts)
    o = np.clip(opac.astype(np.float64), 1e-6, 1 - 1e-6)
    params = {
        "xyz": pts, "scaling": np.log(scales), "rotation": quats,
        "opacity": np.log(o / (1 - o))[:, None],
        "features_dc": shs[:, :1], "features_rest": shs[:, 1:],
    }
    with torch.no_grad():
        return state_from_numpy(params, np.ones(n, bool), 3, device=device)


def render_views(state, cams, device, max_pairs, out_dir):
    """Every view through ``make_render_fn`` at the script's budgets, grown
    (max_pairs and the tile cap doubled) until no view drops a pair, into
    ``out_dir/<image name>``."""
    import dataclasses

    import torch
    from PIL import Image

    from gsjax_torch.ops.rasterize import RasterizeSettings
    from gsjax_torch.train.step import TrainConfig, make_render_fn

    # backend "auto", as the script's: the kernels on CUDA (like gsjax's
    # Pallas kernel on a TPU), the scan capped at max_splats_per_tile on
    # the CPU (like gsjax's XLA scan there)
    settings = RasterizeSettings(max_pairs=max_pairs, max_splats_per_tile=2048, chunk=32,
                                 max_tiles_per_gauss=32, expansion="compact")
    bg = torch.zeros(3, device=device)
    t0 = time.time()
    for i, cam in enumerate(cams):
        rc = cam.to_render_camera(device)
        while True:
            render_fn = make_render_fn(TrainConfig(settings=settings), with_stats=True)
            img, dropped = render_fn(state, rc, bg)
            if int(dropped) == 0:
                break
            if settings.max_pairs >= 1 << 26:
                raise RuntimeError(f"view {i}: {int(dropped)} pairs dropped at max_pairs 1<<26")
            settings = dataclasses.replace(settings, max_pairs=2 * settings.max_pairs,
                                           max_tiles_per_gauss=2 * settings.max_tiles_per_gauss)
        # the script's quantization: floor of 255 x the clipped image
        img = (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(img).save(os.path.join(out_dir, cam.image_name))
        if i % 10 == 0:
            print(f"  rendered {i + 1}/{len(cams)} ({(time.time() - t0) / (i + 1):.2f}s/view)",
                  flush=True)


def write_colmap(out_dir, cams, width, height, pts, col, n_sparse, seed):
    """sparse/0/{cameras,images,points3D}.bin; the SfM-like init is a
    jittered subsample of the GT points with noisy colors."""
    from gsjax_torch.data.colmap import (
        ColmapCamera,
        ColmapImage,
        rotmat_to_qvec,
        write_cameras_binary,
        write_images_binary,
        write_points3d_binary,
    )

    sparse_dir = os.path.join(out_dir, "sparse", "0")
    os.makedirs(sparse_dir, exist_ok=True)
    f_len = 0.5 * width / np.tan(0.5 * FOV_X)
    ccam = ColmapCamera(1, "PINHOLE", width, height,
                        np.array([f_len, f_len, width / 2, height / 2]))
    write_cameras_binary({1: ccam}, os.path.join(sparse_dir, "cameras.bin"))
    # Camera stores R = w2c rotation transposed (reference convention);
    # COLMAP images.bin wants the w2c quaternion + translation
    cimages = {i + 1: ColmapImage(i + 1, rotmat_to_qvec(cam.R.T), cam.T, 1, cam.image_name)
               for i, cam in enumerate(cams)}
    write_images_binary(cimages, os.path.join(sparse_dir, "images.bin"))
    n = len(pts)
    rng = np.random.default_rng(seed + 2)
    sel = rng.choice(n, size=min(n_sparse, n), replace=False)
    sp = pts[sel] + rng.normal(0, 0.01, (len(sel), 3))
    sc = np.clip(col[sel] + rng.normal(0, 0.05, (len(sel), 3)), 0, 1)
    write_points3d_binary(sp, (sc * 255).astype(np.uint8),
                          os.path.join(sparse_dir, "points3D.bin"))
    return len(sel)


PRESETS = {
    # Garden (MipNeRF360) trains at images_4 = 1297x840; 2.2M GT splats
    # whose HF texture cannot be fit by fewer, SfM-like 250k init
    "garden1m": dict(n_gauss=2_200_000, n_views=140, width=1296, height=840,
                     n_sparse=250_000, hf_amp=0.35, coverage=1.6),
    # the same operating point with structured (edge-rich) texture and a
    # sparse init, so the schedule must grow the model through clone/split
    "garden_growth": dict(n_gauss=2_200_000, n_views=120, width=1296, height=840,
                          n_sparse=40_000, structure_amp=0.6, hf_amp=0.18, coverage=1.6),
    # v2: higher camera rings and grain octaves above the GT blur
    "garden_growth2": dict(n_gauss=3_000_000, n_views=120, width=1296, height=840,
                           n_sparse=40_000, structure_amp=0.5, hf_amp=0.35, coverage=1.3),
}
HF_OCTAVES = {
    "garden_growth": ((18.0, 0.5), (40.0, 0.3), (90.0, 0.2)),
    "garden_growth2": ((12.0, 0.45), (26.0, 0.35), (55.0, 0.2)),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description="gsjax_torch synthetic COLMAP scene")
    ap.add_argument("out_dir")
    ap.add_argument("--n_gauss", type=int, default=250_000)
    ap.add_argument("--n_views", type=int, default=120)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--n_sparse", type=int, default=30_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hf_amp", type=float, default=0.0,
                    help="high-frequency noise-texture amplitude")
    ap.add_argument("--coverage", type=float, default=2.0)
    ap.add_argument("--structure_amp", type=float, default=0.0,
                    help="sharp-edged multi-scale patch-texture amplitude")
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda or cpu)")
    args = ap.parse_args(argv)

    from gsjax_torch.utils.system import resolve_device

    device = resolve_device(args.device)  # fail before building anything
    if args.preset:
        for k, v in PRESETS[args.preset].items():
            setattr(args, k, v)

    print(f"building GT model ({args.n_gauss} target gaussians)...", flush=True)
    pts, scales, quats, opac, shs, col = build_gt_model(
        args.n_gauss, args.seed, hf_amp=args.hf_amp, coverage=args.coverage,
        structure_amp=args.structure_amp, hf_octaves=HF_OCTAVES.get(args.preset),
    )
    n = len(pts)
    print(f"  {n} gaussians", flush=True)
    cams = make_cameras(args.n_views, args.width, args.height, args.seed, args.preset)
    img_dir = os.path.join(args.out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    render_views(gt_state(pts, scales, quats, opac, shs, device), cams, device,
                 1 << 23 if n > 1_000_000 else 1 << 22, img_dir)
    n_sel = write_colmap(args.out_dir, cams, args.width, args.height, pts, col,
                         args.n_sparse, args.seed)
    print(f"wrote {args.out_dir}: {len(cams)} views {args.width}x{args.height}, "
          f"{n_sel} sparse points", flush=True)


if __name__ == "__main__":
    main()
