"""Training checkpoints: state + optimizer + iteration (torch).

Counterpart of ``gsjax.train.checkpoint``, in its file format, so a
checkpoint written by either loads in the other. gsjax flattens its
``(GaussianState, opt_state)`` pytree into ``leaf_<i>`` arrays of one
``.npz`` plus a ``__meta__`` JSON string; the port writes and reads the
same leaves in the same order (:data:`LEAVES`): the state's data fields in
declaration order with the parameter dict's keys sorted, then optax's
``ScaleByAdamState(count, mu, nu)`` and ``GroupLrState(count)``.

:func:`load_reference_checkpoint` reads the reference's
``chkpnt<iter>.pth`` (``torch.save((GaussianModel.capture(), iteration))``,
reference train.py:130-132) into a fixed-capacity state.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from gsjax_torch.train.optim import adam_count, adam_moments, with_adam_moments

SORTED_KEYS = ("features_dc", "features_rest", "opacity", "rotation", "scaling", "xyz")
# gsjax's jax.tree_util flatten order of (GaussianState, opt_state)
LEAVES = (
    [("param", k) for k in SORTED_KEYS]
    + [("active",), ("max_radii2d",), ("xyz_grad_accum",), ("denom",), ("active_sh_degree",),
       ("adam_count",)]
    + [("mu", k) for k in SORTED_KEYS]
    + [("nu", k) for k in SORTED_KEYS]
    + [("lr_count",)]
)


def _np(t):
    return t.detach().cpu().numpy()


def save_checkpoint(path, state, opt_state, iteration: int):
    """Write ``state`` and the optimizer ``opt_state`` bound to it."""
    mu, nu = adam_moments(opt_state)
    values = {
        "param": {k: _np(v) for k, v in state.params.items()},
        "mu": {k: _np(v) for k, v in mu.items()},
        "nu": {k: _np(v) for k, v in nu.items()},
        "active": _np(state.active),
        "max_radii2d": _np(state.max_radii2d),
        "xyz_grad_accum": _np(state.xyz_grad_accum),
        "denom": _np(state.denom),
        "active_sh_degree": np.asarray(state.active_sh_degree, np.int32),
        "adam_count": np.asarray(adam_count(opt_state), np.int32),
        "lr_count": np.asarray(opt_state.count, np.int32),
    }
    leaves = [values[p[0]][p[1]] if len(p) == 2 else values[p[0]] for p in LEAVES]
    meta = {
        "iteration": int(iteration),
        "capacity": state.capacity,
        "max_sh_degree": state.max_sh_degree,
        "spatial_lr_scale": state.spatial_lr_scale,
        "num_leaves": len(leaves),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})


@torch.no_grad()
def load_checkpoint(path, make_template):
    """``make_template(capacity, max_sh_degree, spatial_lr_scale) ->
    (state, opt_state)`` builds the target (an optimizer bound to the
    state's parameters); its tensors are refilled from disk in place.
    Returns ``(state, opt_state, iteration)``."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        if meta["num_leaves"] != len(LEAVES):
            raise ValueError(f"{path}: {meta['num_leaves']} leaves, expected {len(LEAVES)} "
                             "(a single-device gsjax checkpoint)")
        leaves = {p: data[f"leaf_{i}"] for i, p in enumerate(LEAVES)}
    state, opt_state = make_template(meta["capacity"], meta["max_sh_degree"],
                                     meta["spatial_lr_scale"])
    dev = state.device
    for k in SORTED_KEYS:
        state.params[k].copy_(torch.from_numpy(leaves["param", k]))
    state.active = torch.from_numpy(leaves["active",]).to(dev)
    state.max_radii2d = torch.from_numpy(leaves["max_radii2d",]).to(dev)
    state.xyz_grad_accum = torch.from_numpy(leaves["xyz_grad_accum",]).to(dev)
    state.denom = torch.from_numpy(leaves["denom",]).to(dev)
    state.active_sh_degree = int(leaves["active_sh_degree",])
    opt_state.count = int(leaves["lr_count",])
    with_adam_moments(opt_state, {k: torch.from_numpy(leaves["mu", k]) for k in SORTED_KEYS},
                      {k: torch.from_numpy(leaves["nu", k]) for k in SORTED_KEYS},
                      count=int(leaves["adam_count",]))
    return state, opt_state, meta["iteration"]


@torch.no_grad()
def load_reference_checkpoint(path, make_template, capacity=None):
    """Load a reference torch checkpoint into a fixed-capacity state.

    ``capture()`` is the tuple (active_sh_degree, _xyz, _features_dc,
    _features_rest, _scaling, _rotation, _opacity, max_radii2D,
    xyz_gradient_accum, denom, optimizer.state_dict(), spatial_lr_scale)
    (reference scene/gaussian_model.py:61-75). Parameters, densification
    accumulators and Adam moments (matched by the reference's param-group
    names) go into the first rows; Adam's count is the groups' step, the
    learning-rate schedule's count the checkpoint's iteration (the
    reference drives its schedule from the loop iteration, train.py:69), as
    gsjax loads it. Returns ``(state, opt_state, iteration)``."""
    capture, iteration = torch.load(path, map_location="cpu", weights_only=False)
    (active_sh, xyz, f_dc, f_rest, scaling, rotation, opacity,
     max_radii2d, grad_accum, denom, opt_sd, spatial_lr_scale) = capture

    def t(x):
        return torch.as_tensor(x.detach() if hasattr(x, "detach") else np.asarray(x),
                               dtype=torch.float32).cpu()

    xyz = t(xyz)
    n = xyz.shape[0]
    rest = t(f_rest).shape[1]
    max_sh = int(round(np.sqrt(rest + 1))) - 1
    cap = capacity or max(64, 1 << int(np.ceil(np.log2(max(n, 1)))))
    if cap < n:
        raise ValueError(f"capacity {cap} < checkpoint points {n}")
    state, opt_state = make_template(cap, max_sh, float(spatial_lr_scale))
    dev = state.device

    values = {"xyz": xyz, "features_dc": t(f_dc), "features_rest": t(f_rest),
              "scaling": t(scaling), "rotation": t(rotation), "opacity": t(opacity)}
    for k, v in values.items():
        state.params[k][:n] = v.to(dev)
    state.active[:n] = True
    state.max_radii2d[:n] = t(max_radii2d).reshape(n).to(dev)
    state.xyz_grad_accum[:n] = t(grad_accum).reshape(n).to(dev)
    state.denom[:n] = t(denom).reshape(n).to(dev)
    state.active_sh_degree = int(active_sh)

    # Adam moments: the reference's param groups carry names
    # (scene/gaussian_model.py:149-162); the padding keeps zero moments
    name_map = {"xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest",
                "opacity": "opacity", "scaling": "scaling", "rotation": "rotation"}
    mu, nu = adam_moments(opt_state)
    mu = {k: v.clone() for k, v in mu.items()}
    nu = {k: v.clone() for k, v in nu.items()}
    count = 0
    for group in opt_sd.get("param_groups", []):
        key = name_map.get(group.get("name"))
        if key is None or not group.get("params"):
            continue
        st = opt_sd.get("state", {}).get(group["params"][0])
        if not st:
            continue
        count = max(count, int(t(st["step"])))
        mu[key][:n] = t(st["exp_avg"]).to(dev)
        nu[key][:n] = t(st["exp_avg_sq"]).to(dev)
    opt_state.count = int(iteration)
    with_adam_moments(opt_state, mu, nu, count=count)
    return state, opt_state, int(iteration)
