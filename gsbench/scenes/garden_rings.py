"""A trained Mip-NeRF 360 garden-sized model on the port's synthetic
garden (``synthetic_scene.PRESETS["garden_growth2"]``), drawn with torch
on the device.

The geometry is the preset's: a ground disk, three spheres, a torus and a
box, each holding gaussians in proportion to its area, flat along the
surface normal (scales sigma, sigma, sigma / 10 with sigma = coverage x
sqrt(area per gaussian), each times exp(N(0, 0.15))), with a random spin in
the surface, opacity U(0.75, 0.98). The preset's procedural texture (47 s
of host numpy) is left out: each surface's palette mean plus N(0, 0.12)
per gaussian gives the colors, and every higher SH coefficient is
N(0, 0.03).

Training poses: the preset's two dome rings (elevations 0.5 and 0.75
with N(0, 0.03) jitter, radius 7 + N(0, 0.15), azimuth steps of 2 pi /
views + N(0, 0.02)), looking at the origin, fov_x 1.1. Viewer: the same
rings without jitter at the viewer's size, one azimuth step a frame, from
a place, ring and direction the seed picks.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from gsbench.reference.cameras import lookat_pose

SH_C0 = 0.28209479177387814


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _quats(R):
    """Rotation matrices (N, 3, 3) to unit quaternions (w, x, y, z),
    Shepperd's branch on the largest squared component."""
    m = R
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    cand = torch.stack([1 + tr, 1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                        1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2],
                        1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]], 1).clamp_min(0)
    best = cand.argmax(1)
    s = 0.5 * torch.sqrt(cand.gather(1, best[:, None])[:, 0].clamp_min(1e-12))
    inv = 1.0 / (4 * s)
    d21, d02, d10 = m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0], m[:, 1, 0] - m[:, 0, 1]
    s01, s02, s12 = m[:, 0, 1] + m[:, 1, 0], m[:, 0, 2] + m[:, 2, 0], m[:, 1, 2] + m[:, 2, 1]
    branches = torch.stack([
        torch.stack([s, d21 * inv, d02 * inv, d10 * inv], 1),
        torch.stack([d21 * inv, s, s01 * inv, s02 * inv], 1),
        torch.stack([d02 * inv, s01 * inv, s, s12 * inv], 1),
        torch.stack([d10 * inv, s02 * inv, s12 * inv, s], 1)])
    q = branches[best, torch.arange(R.shape[0], device=R.device)]
    return _normalize(q)


def _surfaces(gen, device, counts):
    """(points, normals) of each surface, ``counts`` gaussians each."""
    def u(n, *rest):
        return torch.rand((n,) + rest, generator=gen, device=device)

    out = []
    n = counts[0]  # ground disk, radius 4 at z = -0.8
    r, th = 4.0 * torch.sqrt(u(n)), 2 * math.pi * u(n)
    out.append((torch.stack([r * torch.cos(th), r * torch.sin(th), torch.full_like(r, -0.8)], 1),
                torch.tensor([0.0, 0.0, 1.0], device=device).expand(n, 3)))
    for n, (center, radius) in zip(counts[1:4], (((0.0, 0.0, 0.2), 1.0),
                                                 ((1.8, 1.2, -0.3), 0.5),
                                                 ((-1.6, 1.5, -0.35), 0.45))):
        v = _normalize(torch.randn((n, 3), generator=gen, device=device))
        out.append((torch.tensor(center, device=device) + radius * v, v))
    n = counts[4]  # torus, R 0.7, r 0.22
    a, b = 2 * math.pi * u(n), 2 * math.pi * u(n)
    ca, sa, cb, sb = torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b)
    out.append((torch.stack([(0.7 + 0.22 * cb) * ca, (0.7 + 0.22 * cb) * sa, 0.22 * sb], 1)
                + torch.tensor([-1.2, -1.6, -0.55], device=device),
                torch.stack([cb * ca, cb * sa, sb], 1)))
    n = counts[5]  # box, half extents (0.4, 0.4, 0.35)
    half = torch.tensor([0.4, 0.4, 0.35], device=device)
    face = torch.randint(0, 6, (n,), generator=gen, device=device)
    uv = 2 * u(n, 2) - 1
    ax = face // 2
    sgn = 1.0 - 2.0 * (face % 2).to(torch.float32)
    others = torch.stack([(ax + 1) % 3, (ax + 2) % 3], 1).sort(1).values
    pts = torch.zeros((n, 3), device=device)
    nrm = torch.zeros((n, 3), device=device)
    rows = torch.arange(n, device=device)
    pts[rows, ax] = sgn * half[ax]
    pts[rows, others[:, 0]] = uv[:, 0] * half[others[:, 0]]
    pts[rows, others[:, 1]] = uv[:, 1] * half[others[:, 1]]
    nrm[rows, ax] = sgn
    out.append((pts + torch.tensor([1.4, -1.5, -0.45], device=device), nrm))
    return out


AREAS = (math.pi * 4.0 ** 2, 4 * math.pi * 1.0 ** 2, 4 * math.pi * 0.5 ** 2,
         4 * math.pi * 0.45 ** 2, 4 * math.pi ** 2 * 0.7 * 0.22,
         8 * (0.4 * 0.4 + 0.4 * 0.35 + 0.4 * 0.35))
PALETTES = ((0.35, 0.33, 0.24), (0.82, 0.55, 0.35), (0.45, 0.62, 0.78),
            (0.53, 0.70, 0.37), (0.75, 0.55, 0.45), (0.77, 0.52, 0.30))


def build(cfg: dict, seed: int, device) -> dict:
    n, cap = cfg["n_gauss"], cfg["capacity"]
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = np.asarray(AREAS) / sum(AREAS)
    counts = [max(int(wt * n), 1000) for wt in weights]
    counts[0] += n - sum(counts)
    surf = _surfaces(gen, device, counts)
    pts = torch.cat([p for p, _ in surf])
    nrm = _normalize(torch.cat([q for _, q in surf]))
    sigma = torch.cat([torch.full((c,), cfg["coverage"] * math.sqrt(a / c), device=device)
                       for c, a in zip(counts, AREAS)])
    base = torch.cat([torch.tensor(p, device=device).expand(c, 3)
                      for c, p in zip(counts, PALETTES)])

    scales = torch.stack([sigma, sigma, 0.1 * sigma], 1)
    scales = scales * torch.exp(0.15 * torch.randn((n, 3), generator=gen, device=device))
    a = torch.where((nrm[:, 2:3].abs() < 0.9),
                    torch.tensor([0.0, 0.0, 1.0], device=device),
                    torch.tensor([1.0, 0.0, 0.0], device=device))
    t = _normalize(torch.cross(a, nrm, dim=1))
    b = torch.cross(nrm, t, dim=1)
    spin = 2 * math.pi * torch.rand((n, 1), generator=gen, device=device)
    t2 = t * torch.cos(spin) + b * torch.sin(spin)
    b2 = -t * torch.sin(spin) + b * torch.cos(spin)
    quats = _quats(torch.stack([t2, b2, nrm], dim=2))
    opac = 0.75 + 0.23 * torch.rand((n,), generator=gen, device=device)
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

    rng = np.random.default_rng(seed)
    rings, views = cfg["ring_elevations"], cfg["views"]
    train = []
    for i in range(views):
        az = 2 * math.pi * i / views + rng.normal(0, 0.02)
        el = rings[i % 2] + rng.normal(0, 0.03)
        r = cfg["ring_radius"] + rng.normal(0, 0.15)
        eye = (r * math.cos(az) * math.cos(el), r * math.sin(az) * math.cos(el),
               r * math.sin(el))
        train.append(lookat_pose(eye, (0.0, 0.0, 0.0), cfg["fov_x"], cfg["width"],
                                 cfg["height"]))
    centers = np.stack([-p["R"] @ p["T"] for p in train])
    extent = 1.1 * float(np.linalg.norm(centers - centers.mean(0), axis=1).max())

    vw = cfg["viewer"]
    steps = vw["azimuth_steps"]
    view = []
    for el in rings:
        for k in range(steps):
            az = 2 * math.pi * k / steps
            r = cfg["ring_radius"]
            eye = (r * math.cos(az) * math.cos(el), r * math.sin(az) * math.cos(el),
                   r * math.sin(el))
            view.append(lookat_pose(eye, (0.0, 0.0, 0.0), cfg["fov_x"], vw["width"],
                                    vw["height"]))

    def view_path(s):
        g = np.random.default_rng(s)
        ring, k0, d = int(g.integers(len(rings))), int(g.integers(steps)), (
            1 if g.integers(2) else -1)
        for i in itertools.count():
            lap = (ring + i // steps) % len(rings)
            yield lap * steps + (k0 + d * i) % steps

    return {"params": params, "active": active, "sh_degree": 3, "train_poses": train,
            "view_poses": view, "view_path": view_path, "extent": extent}
