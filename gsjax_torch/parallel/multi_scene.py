"""Multi-scene data parallelism: independent scenes side by side on ranks.

Counterpart of ``gsjax.parallel.multi_scene``. The reference trains a
benchmark suite's scenes one after another (reference full_eval.py:39-52);
scenes are independent, so here the world splits into ``n_scenes`` equal
groups of ranks and rank ``r`` trains scene ``r // per`` — its own Gaussian
state, optimizer, cameras and images. There is no cross-scene collective:
the ranks of one scene's group compute the same thing (gsjax's replicated
``inner`` axis). Only logging gathers a number per scene.

gsjax stacks the scenes along a leading axis and steps them in one
program; with one process per rank a rank holds only its scene, so the
step functions here take and return that scene's state, and pick its
entry of the scene-indexed arguments (``cam_idx (S,)``, one key per
scene).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from gsjax_torch.models.gaussians import GaussianState
from gsjax_torch.parallel.multihost import global_to_host_local
from gsjax_torch.train.step import (
    TrainConfig,
    make_densify_step,
    make_train_step,
    make_train_step_chained,
)


@dataclasses.dataclass(frozen=True)
class SceneMesh:
    """One rank's place in the ``scene`` x ``inner`` layout."""

    n_scenes: int
    per: int  # ranks per scene
    scene: int  # the scene this rank trains
    inner: int  # this rank's index within its scene's group


def make_scene_mesh(n_scenes: int) -> SceneMesh:
    """Split the world (one rank without ``torch.distributed``) into
    ``n_scenes`` equal groups; rank ``r`` trains scene ``r // per``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = world // n_scenes
    if per * n_scenes != world:
        raise ValueError(f"{world} ranks do not split into {n_scenes} scenes")
    return SceneMesh(n_scenes=n_scenes, per=per, scene=rank // per, inner=rank % per)


def stack_scene_states(states):
    """Stack per-scene states along a leading scene axis (static fields
    must match across scenes)."""
    s0 = states[0]
    return dataclasses.replace(
        s0,
        params={k: torch.stack([s.params[k].detach() for s in states]) for k in s0.params},
        active=torch.stack([s.active for s in states]),
        max_radii2d=torch.stack([s.max_radii2d for s in states]),
        xyz_grad_accum=torch.stack([s.xyz_grad_accum for s in states]),
        denom=torch.stack([s.denom for s in states]),
    )


def unstack_scene_state(stacked, i: int) -> GaussianState:
    return dataclasses.replace(
        stacked,
        params={k: v[i] for k, v in stacked.params.items()},
        active=stacked.active[i], max_radii2d=stacked.max_radii2d[i],
        xyz_grad_accum=stacked.xyz_grad_accum[i], denom=stacked.denom[i],
    )


def make_multi_scene_train_step(tx, cameras, images, cfg: TrainConfig, mesh: SceneMesh):
    """The train step of this rank's scene.

    ``step(state, opt_state, cam_idx (S,), keys) -> (state, opt_state,
    metrics)``: ``cameras`` and ``images`` are this scene's; the step takes
    ``cam_idx[scene]`` and ``keys[scene]`` (a ``torch.Generator`` per scene,
    or None)."""
    step = make_train_step(tx, cameras, images, cfg)

    def scene_step(state, opt_state, cam_idx, keys=None):
        key = None if keys is None else keys[mesh.scene]
        return step(state, opt_state, int(cam_idx[mesh.scene]), key)

    return scene_step


def make_multi_scene_train_step_chained(tx, cameras, images, cfg: TrainConfig,
                                        mesh: SceneMesh, n_steps: int):
    """``n_steps`` train steps of this rank's scene in one call:
    ``step(state, opt_state, cam_idxs (S, n_steps), keys) -> (state,
    opt_state, last-step metrics + "loss_mean")``."""
    chained = make_train_step_chained(tx, cameras, images, cfg, n_steps)

    def scene_chained(state, opt_state, cam_idxs, keys=None):
        key = None if keys is None else keys[mesh.scene]
        return chained(state, opt_state, [int(c) for c in cam_idxs[mesh.scene]], key)

    return scene_chained


def make_multi_scene_densify_step(opt_params, cfg: TrainConfig, mesh: SceneMesh):
    """Densify / prune and the opacity reset of this rank's scene — the
    single-scene ``make_densify_step``:

    ``densify_step(state, opt_state, keys, use_screen_size) -> (state,
    opt_state, stats)`` with ``keys[scene]`` the split noise's generator,
    and ``reset(state, opt_state) -> (state, opt_state)``."""
    densify, reset = make_densify_step(opt_params, cfg)

    def densify_step(state, opt_state, keys, use_screen_size: bool):
        return densify(state, opt_state, keys[mesh.scene], use_screen_size=use_screen_size)

    return densify_step, reset


def local_scene_ids(mesh: SceneMesh, n_scenes: int):
    """The scenes this rank trains (one)."""
    if n_scenes != mesh.n_scenes:
        raise ValueError(f"the mesh holds {mesh.n_scenes} scenes, not {n_scenes}")
    return [mesh.scene]


def local_scene_state(state, scene_id: int, mesh: SceneMesh, n_scenes: int) -> GaussianState:
    """This rank's scene state, checked to be scene ``scene_id`` (only the
    owning ranks may ask for a scene)."""
    if scene_id not in local_scene_ids(mesh, n_scenes):
        raise ValueError(f"scene {scene_id} is not trained on this rank")
    return state


def scene_values(value, mesh: SceneMesh) -> np.ndarray:
    """A per-scene scalar (this rank's scene's) gathered to every rank as an
    (S,) array, for logging — gsjax's ``global_to_host_local`` of a
    scene-sharded metric."""
    per_rank = global_to_host_local(torch.as_tensor(value, dtype=torch.float64).reshape(()))
    return per_rank[::mesh.per]
