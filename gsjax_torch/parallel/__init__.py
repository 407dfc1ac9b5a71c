"""Multi-rank sharding of the renderer and trainer over ``torch.distributed``.

Counterpart of ``gsjax.parallel``: Gaussians sharded over a ``gauss`` axis
of ranks, image tile strips distributed across the same axis, camera
batches data-parallel over a ``data`` axis, and independent scenes side by
side (``multi_scene``); one process per rank (``multihost``), collectives
with their gradients in ``comm``.
"""

from gsjax_torch.parallel.mesh import make_mesh
from gsjax_torch.parallel.shard import (
    make_sharded_render,
    make_sharded_train_step,
    shard_gaussian_state,
)
from gsjax_torch.parallel.multi_scene import (  # noqa: F401
    make_multi_scene_train_step,
    make_scene_mesh,
    stack_scene_states,
    unstack_scene_state,
)

__all__ = [
    "make_mesh",
    "make_sharded_render",
    "make_sharded_train_step",
    "shard_gaussian_state",
]
