"""A ("data", "tile") layout of ``torch.distributed`` ranks
(``cnmnet_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a named mesh: samples split over
``data``, image rows over ``tile``, collectives derived from sharding
annotations. The port runs one process per card, so its mesh is a layout
of the ranks of a process group: rank ``r`` sits at ``(data_index,
tile_index) = divmod(r, tile)``, and each axis through it is a sub-group of
ranks (``data_group``: the ranks that hold the same rows of other samples;
``tile_group``: the ranks that hold other rows of the same samples).
Collectives name these groups explicitly (``parallel/sharding.py``).

``make_mesh`` has the JAX arithmetic and asserts. With no process group
initialised it is the 1x1 mesh of this one process, and its axes have no
group (``None``): nothing crosses them.

``batch_sharding`` and ``replicated`` are not ported: they annotate where
JAX places an array, and the port's counterpart is that each rank holds
its own slice (``sharding.shard_batch``) and a replica of the parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``("data", "tile")`` layout of ``ranks``."""

    data: int
    tile: int
    ranks: List[int]  # global ranks in mesh order (data-major)
    rank: int  # this process's index in ``ranks``
    group: Optional[object] = None  # the whole mesh's process group (None: the default)
    data_group: Optional[object] = None
    tile_group: Optional[object] = None

    axis_names = ("data", "tile")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "tile": self.tile}

    @property
    def size(self) -> int:
        return self.data * self.tile

    @property
    def data_index(self) -> int:
        return self.rank // self.tile

    @property
    def tile_index(self) -> int:
        return self.rank % self.tile


def make_mesh(data: int = -1, tile: int = 1, group=None) -> Mesh:
    """Lay the ranks of ``group`` (the default group when None) out as a
    ``data x tile`` mesh; ``data=-1`` takes every rank left. Every rank of
    the default group must call it, in the same order: the sub-groups are
    made with ``torch.distributed.new_group``. Once a process group is
    initialised every axis has one, one rank wide or not, so a run on one
    card goes through the same collectives as a run on many."""
    if _initialized():
        ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
        rank = ranks.index(dist.get_rank())
    else:
        ranks, rank = [0], 0
    n = len(ranks)
    if data == -1:
        assert n % tile == 0, (n, tile)
        data = n // tile
    assert data * tile == n, f"mesh {data}x{tile} != {n} devices"
    if not _initialized():
        return Mesh(data, tile, ranks, rank)
    data_groups = [_axis_group([ranks[d * tile + t] for d in range(data)], n, group)
                   for t in range(tile)]
    tile_groups = [_axis_group([ranks[d * tile + t] for t in range(tile)], n, group)
                   for d in range(data)]
    return Mesh(data, tile, ranks, rank, group,
                data_group=data_groups[rank % tile], tile_group=tile_groups[rank // tile])


def _axis_group(members: List[int], n: int, group):
    """The process group of one axis line: the mesh's own group when the
    line holds every rank, else a new group."""
    if len(members) == n:
        return group or dist.group.WORLD
    return dist.new_group(members)


def local_batch_size(global_batch: int, mesh: Optional[Mesh] = None) -> int:
    """This process's share of ``global_batch`` (``global_batch`` over the
    process count, which must divide it), as in JAX."""
    count = dist.get_world_size() if _initialized() else 1
    per_proc = global_batch // count
    assert per_proc * count == global_batch
    return per_proc
