"""The rank mesh: ``data`` x ``gauss`` over ``torch.distributed``.

Counterpart of ``gsjax.parallel.mesh``. Axes: ``data`` = camera batch
(gradients averaged across it), ``gauss`` = the Gaussian axis (rows
sharded, tile strips distributed). ``gauss`` is innermost, as in gsjax:
rank ``r = d * gauss + g``, so a ``gauss`` row is a run of consecutive
ranks (on a multi-GPU host, the cards that share the fastest links).

Every rank builds the same process groups in the same order (one per
``gauss`` row, then one per ``data`` column): ``dist.new_group`` is a
collective over the whole world.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from gsjax_torch.parallel.multihost import rank_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the ``data`` x ``gauss`` layout."""

    data: int
    gauss: int
    rank: int
    d: int  # this rank's data row
    g: int  # this rank's gauss column (its tile strip and row block)
    gauss_group: object  # the ranks of this data row
    data_group: object  # the ranks of this gauss column
    backend: str
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"data": self.data, "gauss": self.gauss}

    @property
    def world(self) -> int:
        return self.data * self.gauss


def make_mesh(data: int = 1, gauss: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh over the initialized world (``multihost.maybe_initialize``).
    ``gauss`` defaults to world // data; data * gauss must equal the world
    size (one rank per mesh slot). ``device`` is the rank's device kind
    (``"cuda"`` or ``"cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "the mesh spans ranks: torch.distributed is not initialized (launch one "
            "process per rank with --dist_* / GSJAX_* variables, or --multihost under "
            "torchrun; multihost.maybe_initialize)")
    world = dist.get_world_size()
    if gauss is None:
        gauss = world // data
    if data * gauss != world:
        raise ValueError(f"mesh {data}x{gauss} does not match {world} ranks")
    rank = dist.get_rank()
    d, g = divmod(rank, gauss)
    gauss_group = data_group = None
    for dd in range(data):  # the same order on every rank
        grp = dist.new_group([dd * gauss + gg for gg in range(gauss)])
        if dd == d:
            gauss_group = grp
    for gg in range(gauss):
        grp = dist.new_group([dd * gauss + gg for dd in range(data)])
        if gg == g:
            data_group = grp
    mesh = Mesh(data=data, gauss=gauss, rank=rank, d=d, g=g, gauss_group=gauss_group,
                data_group=data_group, backend=dist.get_backend(),
                device=rank_device(device))
    if rank == 0:
        print(f"[mesh] data {data} x gauss {gauss} on {world} ranks, backend "
              f"{mesh.backend}", flush=True)
    return mesh
