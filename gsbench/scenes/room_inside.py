"""A trained Mip-NeRF 360 ``room``-sized model seen from inside, drawn with
torch on the device.

Geometry: a box room (``room``: x, y and z sizes, floor at z = 0) with its
floor, ceiling and four walls, and furniture as boxes: a table at the
centre with spheres and boxes on it, a sofa (seat and back) against one
wall and cabinets against the others (``FURNITURE``, ``SPHERES``). A point
of one surface that lies inside another piece is hidden and holds nothing.

Density like a trained model's: 3DGS densifies until gaussians are a few
pixels wide in the views that see them. So a surface point holds gaussians
with density proportional to 1 / d^2, d the distance to the nearest
training camera that sees it (in its frustum, in front of its near plane,
the surface facing it; occlusion is ignored), and a gaussian's sigma is
``sigma_px`` x d / f, f the focal length in pixels: ``sigma_px`` pixels
wide in that camera. Points no camera sees hold none. The draw is a
rejection sampling of uniform surface points, each kept with probability
(``NEAR`` / d)^2 (d clamped at ``NEAR``), in chunks until ``n_gauss`` are
kept. Gaussians are flat along the surface (scales sigma, sigma, sigma /
10, each times exp(N(0, 0.15))), with a random spin in the surface,
opacity U(0.75, 0.98), colors from each surface's palette plus N(0, 0.12)
and every higher SH coefficient N(0, ``sh_rest_std``).

A tail of wide footprints: a ``tail_frac`` share of the gaussians is
U(``tail_wide``) times wider, with opacity U(``tail_opacity``), the large
background gaussians and floaters that trained models keep.

Training poses: ``views`` poses on a jittered loop inside the room (radius
U(``loop_radius``) around its centre, height U(``loop_height``), azimuth
steps of 2 pi / views + N(0, 0.02)), each looking at a point of the
central group (``target`` + N(0, 0.15) across, N(0, 0.05) up), inward
facing all round as the capture is, fov_x ``fov_x``. Viewer: the same loop
without jitter, at the training size, a pose a frame from a place and
direction the seed picks.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from gsbench.reference.cameras import lookat_pose
from gsbench.scenes.garden_rings import SH_C0, _normalize, _quats

NEAR = 0.4  # m: distances below this count as this in the density and the sigma
CHUNK = 1 << 23  # candidate surface points a draw

# (centre, half extents, palette) of each piece of furniture, metres, floor at z = 0
FURNITURE = (
    ((0.0, 0.0, 0.375), (0.6, 0.4, 0.375), (0.50, 0.35, 0.22)),  # table
    ((-0.1, 0.2, 0.85), (0.1, 0.1, 0.1), (0.80, 0.25, 0.20)),  # box on the table
    ((0.35, -0.2, 0.875), (0.15, 0.075, 0.125), (0.20, 0.45, 0.70)),  # box on the table
    ((2.55, 0.0, 0.225), (0.45, 1.1, 0.225), (0.30, 0.35, 0.55)),  # sofa seat
    ((2.875, 0.0, 0.425), (0.125, 1.1, 0.425), (0.28, 0.32, 0.52)),  # sofa back
    ((-1.5, 2.25, 0.9), (0.5, 0.25, 0.9), (0.60, 0.50, 0.40)),  # tall cabinet
    ((0.8, -2.275, 0.5), (0.4, 0.225, 0.5), (0.75, 0.72, 0.68)),  # low cabinet
    ((-2.75, 0.6, 0.6), (0.25, 0.6, 0.6), (0.35, 0.30, 0.28)),  # cabinet
)
# (centre, radius, palette) of the spheres on the table
SPHERES = (((0.25, 0.1, 0.87), 0.12, (0.85, 0.75, 0.30)),
           ((-0.3, -0.15, 0.83), 0.08, (0.30, 0.60, 0.35)))
ROOM_PALETTES = ((0.45, 0.32, 0.20), (0.90, 0.90, 0.88), (0.82, 0.80, 0.74),
                 (0.78, 0.76, 0.70))  # floor, ceiling, the walls across x, across y


def _faces(centre, half, inward: bool):
    """The six faces of a box as (origin, u, v, normal), -x, +x, -y, +y, -z,
    +z: points origin + a u + b v for a, b in [0, 1]."""
    c, h = np.asarray(centre, np.float64), np.asarray(half, np.float64)
    out = []
    for ax in range(3):
        o1, o2 = (ax + 1) % 3, (ax + 2) % 3
        for sgn in (-1.0, 1.0):
            origin = c.copy()
            origin[ax] += sgn * h[ax]
            origin[o1] -= h[o1]
            origin[o2] -= h[o2]
            u, v, n = np.zeros(3), np.zeros(3), np.zeros(3)
            u[o1], v[o2] = 2 * h[o1], 2 * h[o2]
            n[ax] = -sgn if inward else sgn
            out.append((origin, u, v, n))
    return out


def surfaces(cfg: dict):
    """Every planar face (origin, u, v, normal, palette, owner) and sphere
    (centre, radius, palette, owner); owner -1 is the room, whose size
    ``room`` is (x, y, z) in metres, centred on the z axis."""
    size = np.asarray(cfg["room"], np.float64)
    floor, ceiling, wall_x, wall_y = ROOM_PALETTES
    room = zip(_faces((0.0, 0.0, size[2] / 2), size / 2, True),
               (wall_x, wall_x, wall_y, wall_y, floor, ceiling))
    planes = [(*f, pal, -1) for f, pal in room]
    for i, (c, h, pal) in enumerate(FURNITURE):
        planes += [(*f, pal, i) for f in _faces(c, h, False)]
    spheres = [(c, r, pal, len(FURNITURE) + j) for j, (c, r, pal) in enumerate(SPHERES)]
    return planes, spheres


def _hidden(pts, owner, device):
    """Points inside a piece of furniture other than their own (a floor
    under a cabinet, a table top under a box): nothing sees them."""
    hid = torch.zeros(pts.shape[0], dtype=torch.bool, device=device)
    for i, (c, h, _) in enumerate(FURNITURE):
        c, h = torch.tensor(c, device=device), torch.tensor(h, device=device)
        inside = ((pts - c).abs() <= h + 1e-3).all(1)
        hid |= inside & (owner != i)
    for j, (c, r, _) in enumerate(SPHERES):
        c = torch.tensor(c, device=device)
        inside = torch.linalg.vector_norm(pts - c, dim=1) <= r + 1e-3
        hid |= inside & (owner != len(FURNITURE) + j)
    return hid


def _candidates(gen, device, planes, spheres, m):
    """``m`` points uniform over the surfaces' area, with their normals,
    palettes and owners."""
    areas = [float(np.linalg.norm(np.cross(u, v))) for _, u, v, _, _, _ in planes]
    areas += [4 * math.pi * r * r for _, r, _, _ in spheres]
    total = sum(areas)
    counts = [int(m * a / total) for a in areas]
    pts, nrm, pal, own = [], [], [], []
    for (o, u, v, n, p, ow), k in zip(planes, counts):
        ab = torch.rand((k, 2), generator=gen, device=device, dtype=torch.float64)
        t = torch.tensor
        pts.append(t(o, device=device) + ab[:, :1] * t(u, device=device)
                   + ab[:, 1:] * t(v, device=device))
        nrm.append(t(n, device=device).expand(k, 3))
        pal.append(t(p, device=device, dtype=torch.float64).expand(k, 3))
        own.append(torch.full((k,), ow, device=device))
    for (c, r, p, ow), k in zip(spheres, counts[len(planes):]):
        d = _normalize(torch.randn((k, 3), generator=gen, device=device, dtype=torch.float64))
        pts.append(torch.tensor(c, device=device) + r * d)
        nrm.append(d)
        pal.append(torch.tensor(p, device=device, dtype=torch.float64).expand(k, 3))
        own.append(torch.full((k,), ow, device=device))
    return (torch.cat(pts).float(), torch.cat(nrm).float(), torch.cat(pal).float(),
            torch.cat(own))


def _seen_distance(pts, nrm, poses, device):
    """The distance from each point to the nearest pose that sees it (in
    its frustum, beyond z 0.2, the surface facing it), inf where none."""
    best = torch.full((pts.shape[0],), math.inf, device=device)
    for p in poses:
        w2c = torch.tensor(np.asarray(p["R"]).T, dtype=torch.float32, device=device)
        t = torch.tensor(p["T"], dtype=torch.float32, device=device)
        centre = -(w2c.T @ t)
        q = pts @ w2c.T + t
        z = q[:, 2]
        seen = ((z > 0.2) & (q[:, 0].abs() < math.tan(p["fov_x"] / 2) * z)
                & (q[:, 1].abs() < math.tan(p["fov_y"] / 2) * z)
                & (((centre - pts) * nrm).sum(1) > 0))
        d = torch.linalg.vector_norm(pts - centre, dim=1)
        best = torch.where(seen, torch.minimum(best, d), best)
    return best


def train_poses(cfg: dict, seed: int) -> list:
    rng = np.random.default_rng(seed)
    views, target = cfg["views"], np.asarray(cfg["target"], np.float64)
    out = []
    for i in range(views):
        az = 2 * math.pi * i / views + rng.normal(0, 0.02)
        r = rng.uniform(*cfg["loop_radius"])
        eye = (r * math.cos(az), r * math.sin(az), rng.uniform(*cfg["loop_height"]))
        look = target + np.array([rng.normal(0, 0.15), rng.normal(0, 0.15),
                                  rng.normal(0, 0.05)])
        out.append(lookat_pose(eye, look, cfg["fov_x"], cfg["width"], cfg["height"]))
    return out


def require_training_probe():
    """Refuse, before set-up, a program whose training probe cannot hold
    this scene under its own budgets. Its views differ widely and a few
    footprints cover thousands of tiles: a probe of four cameras misses the
    widest, and a compact expansion's cap sized to the probed footprints
    cuts one that another view or training widens, so such a program drops
    pairs on some seeds. The probe that holds it measures every training
    camera and starts a compact cap at the frame's tile count
    (``gsjax_torch.train.loop.frame_tile_cap``)."""
    from gsjax_torch.train import loop

    if not hasattr(loop, "frame_tile_cap"):
        raise SystemExit("room_inside: this program's training probe measures four cameras "
                         "and keeps the probed tile cap; the scene needs one that measures "
                         "every camera and starts a compact cap at the frame's tile count")


def build(cfg: dict, seed: int, device) -> dict:
    require_training_probe()
    n, cap = cfg["n_gauss"], cfg["capacity"]
    gen = torch.Generator(device=device).manual_seed(seed)
    train = train_poses(cfg, seed)
    focal = cfg["width"] / (2 * math.tan(cfg["fov_x"] / 2))

    planes, spheres = surfaces(cfg)
    kept, m = [], min(CHUNK, max(1 << 16, 64 * n))
    got = 0
    while got < n:
        pts, nrm, pal, own = _candidates(gen, device, planes, spheres, m)
        d = _seen_distance(pts, nrm, train, device).clamp_min(NEAR)
        d = torch.where(_hidden(pts, own, device), math.inf, d)
        keep = torch.rand(d.shape, generator=gen, device=device) < (NEAR / d) ** 2
        kept.append((pts[keep], nrm[keep], pal[keep], d[keep]))
        got += int(keep.sum())
    pts, nrm, base, dist = (torch.cat(x)[:n] for x in zip(*kept))

    sigma = cfg["sigma_px"] * dist / focal
    scales = torch.stack([sigma, sigma, 0.1 * sigma], 1)
    scales = scales * torch.exp(0.15 * torch.randn((n, 3), generator=gen, device=device))
    opac = 0.75 + 0.23 * torch.rand((n,), generator=gen, device=device)
    tail = torch.rand((n,), generator=gen, device=device) < cfg["tail_frac"]
    lo, hi = cfg["tail_wide"]
    wide = lo + (hi - lo) * torch.rand((n, 1), generator=gen, device=device)
    scales = torch.where(tail[:, None], scales * wide, scales)
    lo, hi = cfg["tail_opacity"]
    opac = torch.where(tail, lo + (hi - lo) * torch.rand((n,), generator=gen, device=device),
                       opac)
    a = torch.where((nrm[:, 2:3].abs() < 0.9), torch.tensor([0.0, 0.0, 1.0], device=device),
                    torch.tensor([1.0, 0.0, 0.0], device=device))
    t = _normalize(torch.cross(a, nrm, dim=1))
    b = torch.cross(nrm, t, dim=1)
    spin = 2 * math.pi * torch.rand((n, 1), generator=gen, device=device)
    t2 = t * torch.cos(spin) + b * torch.sin(spin)
    b2 = -t * torch.sin(spin) + b * torch.cos(spin)
    quats = _quats(torch.stack([t2, b2, nrm], dim=2))
    col = (base + 0.12 * torch.randn((n, 3), generator=gen, device=device)).clamp(0.02, 0.98)

    params = {
        "xyz": torch.zeros((cap, 3), device=device),
        "features_dc": torch.zeros((cap, 1, 3), device=device),
        "features_rest": torch.zeros((cap, 15, 3), device=device),
        "scaling": torch.zeros((cap, 3), device=device),
        "rotation": torch.zeros((cap, 4), device=device),
        "opacity": torch.zeros((cap, 1), device=device),
    }
    params["rotation"][:, 0] = 1.0
    params["xyz"][:n] = pts
    params["scaling"][:n] = torch.log(scales)
    params["rotation"][:n] = quats
    params["opacity"][:n, 0] = torch.log(opac / (1 - opac))
    params["features_dc"][:n, 0] = (col - 0.5) / SH_C0
    params["features_rest"][:n] = cfg["sh_rest_std"] * torch.randn(
        (n, 15, 3), generator=gen, device=device)
    active = torch.zeros(cap, dtype=torch.bool, device=device)
    active[:n] = True

    centers = np.stack([-p["R"] @ p["T"] for p in train])
    extent = 1.1 * float(np.linalg.norm(centers - centers.mean(0), axis=1).max())

    views, target = cfg["views"], tuple(cfg["target"])
    r, z = sum(cfg["loop_radius"]) / 2, sum(cfg["loop_height"]) / 2
    view = [lookat_pose((r * math.cos(2 * math.pi * k / views),
                         r * math.sin(2 * math.pi * k / views), z), target, cfg["fov_x"],
                        cfg["width"], cfg["height"]) for k in range(views)]

    def view_path(s):
        g = np.random.default_rng(s)
        k0, step = int(g.integers(views)), (1 if g.integers(2) else -1)
        return ((k0 + step * i) % views for i in itertools.count())

    return {"params": params, "active": active, "sh_degree": 3, "train_poses": train,
            "view_poses": view, "view_path": view_path, "extent": extent}
