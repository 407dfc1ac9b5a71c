"""Fixed-capacity Gaussian scene state (torch).

Counterpart of ``gsjax.models.gaussians``: all attributes live in
fixed-capacity structure-of-arrays tensors (capacity C) with a boolean
``active`` mask, so a state compares slot for slot with gsjax's.

Parameter layout (pre-activation; reference scene/gaussian_model.py:47-52):
  xyz (C,3) | features_dc (C,1,3) | features_rest (C,15,3) |
  scaling (C,3) log | rotation (C,4) quat wxyz | opacity (C,1) logit

Activations (reference :33-41): exp / L2-normalize / sigmoid.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from gsjax_torch.data.ply import read_ply, write_ply
from gsjax_torch.utils.math import safe_normalize
from gsjax_torch.utils.sh import num_sh_coeffs, rgb_to_sh
from gsjax_torch.utils.system import resolve_device

Params = Dict[str, torch.Tensor]

PARAM_KEYS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
INIT_OPACITY = 0.1  # reference: scene/gaussian_model.py:139


@dataclasses.dataclass
class GaussianState:
    """All per-Gaussian state, as tensors on one device."""

    params: Params
    active: torch.Tensor  # (C,) bool
    max_radii2d: torch.Tensor  # (C,) float32 — max observed screen radius
    xyz_grad_accum: torch.Tensor  # (C,) float32 — sum ||grad means2d (ndc)||
    denom: torch.Tensor  # (C,) float32 — observation counts
    active_sh_degree: int
    max_sh_degree: int = 3
    spatial_lr_scale: float = 1.0

    @property
    def capacity(self) -> int:
        return self.params["xyz"].shape[0]

    @property
    def device(self) -> torch.device:
        return self.params["xyz"].device

    @property
    def num_active(self) -> torch.Tensor:
        return self.active.sum().to(torch.int32)


def activated_params(p: Params):
    """Post-activation attributes from a raw parameter dict:
    (means3d, scales, quats, opacities, shs)."""
    scales = torch.exp(p["scaling"])
    quats = safe_normalize(p["rotation"])
    opacities = torch.sigmoid(p["opacity"][:, 0])
    shs = torch.cat([p["features_dc"], p["features_rest"]], dim=1)
    return p["xyz"], scales, quats, opacities, shs


def activated(state: GaussianState):
    """Post-activation attributes: (means3d, scales, quats, opacities, shs)."""
    return activated_params(state.params)


def create_empty(capacity: int, max_sh_degree: int = 3, spatial_lr_scale=1.0,
                 device="cuda") -> GaussianState:
    dev = resolve_device(device)
    rest = num_sh_coeffs(max_sh_degree) - 1

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    rotation = z(capacity, 4)
    rotation[:, 0] = 1.0
    return GaussianState(
        params={
            "xyz": z(capacity, 3),
            "features_dc": z(capacity, 1, 3),
            "features_rest": z(capacity, rest, 3),
            "scaling": z(capacity, 3),
            "rotation": rotation,
            "opacity": z(capacity, 1),
        },
        active=torch.zeros(capacity, dtype=torch.bool, device=dev),
        max_radii2d=z(capacity),
        xyz_grad_accum=z(capacity),
        denom=z(capacity),
        active_sh_degree=0,
        max_sh_degree=max_sh_degree,
        spatial_lr_scale=float(spatial_lr_scale),
    )


def round_capacity(n: int, multiple: int = 4096) -> int:
    return max(multiple, int(math.ceil(n / multiple)) * multiple)


def knn_mean_sq_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean squared distance of each point to its k nearest neighbors.

    Host-side replacement for the reference's ``simple_knn._C.distCUDA2``
    CUDA kernel (reference: scene/gaussian_model.py:134): the exact C++
    KD-tree of :mod:`gsjax_torch.native`, gsjax's, with ``min(k, n - 1)``
    neighbours (0 for one point). Runs once at init; raises when the tree
    cannot be built."""
    from gsjax_torch.native import knn_mean_sq_dist as native_knn

    return native_knn(points, k)


def create_from_pcd(points, colors, spatial_lr_scale: float, max_sh_degree: int = 3,
                    capacity: int | None = None, device="cuda") -> GaussianState:
    """Initialize one Gaussian per SfM point.

    Same init as gsjax and the reference (scene/gaussian_model.py:124-147):
    SH DC from RGB, isotropic log-scale from sqrt(mean 3-NN squared
    distance) clamped at 1e-7, identity rotations, opacity 0.1."""
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.float32)
    n = points.shape[0]
    capacity = capacity or round_capacity(int(n * 1.5))
    if capacity < n:
        raise ValueError(f"capacity {capacity} < number of points {n}")

    dist2 = np.maximum(knn_mean_sq_dist(points), 1e-7)
    log_scales = np.repeat(np.log(np.sqrt(dist2))[:, None], 3, axis=1)

    state = create_empty(capacity, max_sh_degree, spatial_lr_scale, device=device)
    p = state.params
    dev = state.device
    p["xyz"][:n] = torch.from_numpy(points).to(dev)
    p["features_dc"][:n, 0] = rgb_to_sh(torch.from_numpy(colors)).to(dev)
    p["scaling"][:n] = torch.from_numpy(log_scales.astype(np.float32)).to(dev)
    init = torch.tensor(INIT_OPACITY, dtype=torch.float32)
    p["opacity"][:n] = float(torch.log(init / (1.0 - init)))
    state.active[:n] = True
    return state


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Re-bucket into a larger buffer: every per-Gaussian tensor is
    zero-padded to ``new_capacity`` (fresh tensors; an optimizer over the
    old ones is carried over by ``train.optim.grow_optimizer``)."""
    if new_capacity < state.capacity:
        raise ValueError("can only grow")

    def pad(a):
        a = a.detach()
        out = torch.zeros((new_capacity,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        out[: a.shape[0]] = a
        return out

    return dataclasses.replace(
        state,
        params={k: pad(v) for k, v in state.params.items()},
        active=pad(state.active),
        max_radii2d=pad(state.max_radii2d),
        xyz_grad_accum=pad(state.xyz_grad_accum),
        denom=pad(state.denom),
    )


# --------------------------------------------------------------------------
# Weight carry-over from gsjax: a gsjax GaussianState's arrays as numpy.
# --------------------------------------------------------------------------


def state_from_numpy(params: Dict[str, np.ndarray], active, active_sh_degree, *,
                     max_sh_degree: int = 3, spatial_lr_scale: float = 1.0,
                     device="cuda") -> GaussianState:
    """Build a state from gsjax ``GaussianState`` arrays given as numpy
    (``{k: np.asarray(v) for k, v in state.params.items()}``,
    ``np.asarray(state.active)``, ``int(state.active_sh_degree)``). The
    density-control statistics start at zero."""
    dev = resolve_device(device)
    missing = set(PARAM_KEYS) - set(params)
    if missing:
        raise ValueError(f"params missing {sorted(missing)}")

    def tensor(x, dtype=np.float32):  # a fresh copy: the state owns its tensors
        return torch.from_numpy(np.array(x, dtype)).to(dev)

    p = {k: tensor(params[k]) for k in PARAM_KEYS}
    c = p["xyz"].shape[0]
    return GaussianState(
        params=p,
        active=tensor(active, bool),
        max_radii2d=torch.zeros(c, dtype=torch.float32, device=dev),
        xyz_grad_accum=torch.zeros(c, dtype=torch.float32, device=dev),
        denom=torch.zeros(c, dtype=torch.float32, device=dev),
        active_sh_degree=int(active_sh_degree),
        max_sh_degree=int(max_sh_degree),
        spatial_lr_scale=float(spatial_lr_scale),
    )


def state_to_numpy(state: GaussianState) -> dict:
    """The inverse of :func:`state_from_numpy`: a dict of numpy arrays
    (``params``, ``active``, ``max_radii2d``, ``xyz_grad_accum``,
    ``denom``) plus ``active_sh_degree``, ``max_sh_degree`` and
    ``spatial_lr_scale``."""

    def np_(t):
        return t.detach().cpu().numpy()

    return {
        "params": {k: np_(v) for k, v in state.params.items()},
        "active": np_(state.active),
        "max_radii2d": np_(state.max_radii2d),
        "xyz_grad_accum": np_(state.xyz_grad_accum),
        "denom": np_(state.denom),
        "active_sh_degree": int(state.active_sh_degree),
        "max_sh_degree": int(state.max_sh_degree),
        "spatial_lr_scale": float(state.spatial_lr_scale),
    }


# --------------------------------------------------------------------------
# PLY interchange — byte-compatible with the 3DGS ecosystem format
# (reference: scene/gaussian_model.py:177-256). Attribute order:
# x y z nx ny nz f_dc_0..2 f_rest_0..44 opacity scale_0..2 rot_0..3,
# f_dc/f_rest flattened channel-major.
# --------------------------------------------------------------------------


def save_gaussian_ply(state: GaussianState, path):
    keep = state.active.cpu().numpy()
    p = {k: v.detach().cpu().numpy().astype(np.float32)[keep]
         for k, v in state.params.items()}
    n = p["xyz"].shape[0]
    f_dc = p["features_dc"].transpose(0, 2, 1).reshape(n, -1)  # (n, 3)
    f_rest = p["features_rest"].transpose(0, 2, 1).reshape(n, -1)  # (n, 45)
    props = {}
    for i, name in enumerate("xyz"):
        props[name] = p["xyz"][:, i]
    for name in ("nx", "ny", "nz"):
        props[name] = np.zeros(n, np.float32)
    for i in range(f_dc.shape[1]):
        props[f"f_dc_{i}"] = f_dc[:, i]
    for i in range(f_rest.shape[1]):
        props[f"f_rest_{i}"] = f_rest[:, i]
    props["opacity"] = p["opacity"][:, 0]
    for i in range(p["scaling"].shape[1]):
        props[f"scale_{i}"] = p["scaling"][:, i]
    for i in range(p["rotation"].shape[1]):
        props[f"rot_{i}"] = p["rotation"][:, i]
    write_ply(path, props)


def load_gaussian_ply(path, max_sh_degree: int = 3, capacity: int | None = None,
                      spatial_lr_scale=1.0, device="cuda") -> GaussianState:
    v = read_ply(path)["vertex"]
    n = len(v["x"])
    rest = num_sh_coeffs(max_sh_degree) - 1
    arrays = {
        "xyz": np.stack([v["x"], v["y"], v["z"]], axis=1),
        "features_dc": np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1)[:, None, :],
        "features_rest": (
            np.stack([v[f"f_rest_{i}"] for i in range(3 * rest)], axis=1)
            .reshape(n, 3, rest)
            .transpose(0, 2, 1)
        ),
        "scaling": np.stack([v[f"scale_{i}"] for i in range(3)], axis=1),
        "rotation": np.stack([v[f"rot_{i}"] for i in range(4)], axis=1),
        "opacity": v["opacity"][:, None],
    }
    capacity = capacity or round_capacity(int(n * 1.5))
    state = create_empty(capacity, max_sh_degree, spatial_lr_scale, device=device)
    for key, arr in arrays.items():
        state.params[key][:n] = torch.as_tensor(arr.astype(np.float32), device=state.device)
    state.active[:n] = True
    # loaded models render at full SH degree (reference :256)
    state.active_sh_degree = max_sh_degree
    return state
