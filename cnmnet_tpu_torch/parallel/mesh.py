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

``RowPlan`` is the tile axis's layout of rows: which global rows each tile
index holds at every resolution of the CNM conv schedule (1, 1/2, ...,
1/32), and which rows each windowed stage reads. GSPMD derives this from
the sharding annotations; the port states it, so every windowed layer
knows the global rows of its shard (``parallel/sharding.Spatial``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

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

    @property
    def mesh_group(self):
        """The process group of the whole mesh (None: no process group, one
        rank)."""
        if self.data_group is None:
            return None
        return self.group or dist.group.WORLD


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


Rows = Tuple[int, int]  # [start, stop) global rows

# The CNM conv schedule's windowed stages, as (name, kind, input level,
# kernel, stride): level L is the 1/2^L resolution. A "conv" reads a k x k
# window with (k - 1) // 2 zero rows at the border; "bilinear" and
# "nearest" upsample x2 from level L to L - 1. DepthNet's encoder (kernels
# 7/5/3/3/3, stride 1 then 2 at each level) and its upsamplings; its
# decoder's k = 3 convs and all of RefineNet (k = 3, levels 0-3) read no
# more rows than a stage listed at the same level.
CNM_STAGES = (
    ("depth_net.conv1", "conv", 0, 7, 1), ("depth_net.conv1 (stride 2)", "conv", 0, 7, 2),
    ("depth_net.conv2", "conv", 1, 5, 1), ("depth_net.conv2 (stride 2)", "conv", 1, 5, 2),
    ("depth_net.conv3", "conv", 2, 3, 1), ("depth_net.conv3 (stride 2)", "conv", 2, 3, 2),
    ("depth_net.conv4", "conv", 3, 3, 1), ("depth_net.conv4 (stride 2)", "conv", 3, 3, 2),
    ("depth_net.conv5", "conv", 4, 3, 1), ("depth_net.conv5 (stride 2)", "conv", 4, 3, 2),
    ("depth_net.upconv5", "bilinear", 5, None, None),
    ("depth_net.upconv4", "bilinear", 4, None, None),
    ("depth_net.upconv3", "bilinear", 3, None, None), ("depth_net.udisp4", "nearest", 3, None, None),
    ("depth_net.upconv2", "bilinear", 2, None, None), ("depth_net.udisp3", "nearest", 2, None, None),
    ("depth_net.upconv1", "bilinear", 1, None, None), ("depth_net.udisp2", "nearest", 1, None, None),
)


def split_rows(extent: int, tile: int) -> List[Rows]:
    """The balanced split of ``extent`` rows over ``tile`` indices: index
    ``i`` holds ``[i * extent // tile, (i + 1) * extent // tile)``."""
    return [(i * extent // tile, (i + 1) * extent // tile) for i in range(tile)]


def conv_input_rows(out: Rows, k: int, stride: int) -> Rows:
    """The input rows ``[lo, hi)`` that output rows ``out`` of a size-``k``,
    stride-``stride`` conv with ``(k - 1) // 2`` padding read: output row
    ``j`` reads ``stride j - pad ... stride j - pad + k - 1``. Rows outside
    the image are its zero padding."""
    pad = (k - 1) // 2
    a, b = out
    return stride * a - pad, stride * (b - 1) - pad + k


def upsample_input_rows(out: Rows, extent_in: int, mode: str) -> Rows:
    """The input rows ``[lo, hi)`` that output rows ``out`` = ``[a, b)`` of
    a x2 upsampling (half-pixel centres) read. Bilinear: output row ``j``
    reads rows ``floor((j + 0.5) / 2 - 0.5)`` and the next, each clamped
    into the image (edge clamping: no padding rows), which for ``[a, b)``
    are rows ``(a - 1) // 2`` to ``b // 2``. Nearest: row ``j // 2``."""
    a, b = out
    if mode == "nearest":
        return a // 2, (b - 1) // 2 + 1
    if mode != "bilinear":
        raise ValueError(f"unknown upsampling {mode!r}")
    return max((a - 1) // 2, 0), min(b // 2 + 1, extent_in)


class RowPlan:
    """The rows of an image of ``height`` rows split over ``tile`` indices
    at every level of the CNM conv schedule (level L: ``height / 2^L``
    rows, L = 0..5). Each level is split on its own (``split_rows``), so
    at 480 rows and tile 2 the 15 rows at 1/32 split 7/8; where an
    upsampled map meets a skip of the finer level, the upsampling reads the
    coarse rows it needs from their owners (the reshard GSPMD makes
    silently). Refuses, with a ``ValueError`` naming the level or the
    stage, a height the model cannot take (not divisible by 32), a level
    with fewer rows than tiles, and a stage whose rows lie beyond a
    neighbouring tile index."""

    LEVELS = 6

    def __init__(self, height: int, tile: int, stages: Sequence = CNM_STAGES):
        self.height, self.tile = int(height), int(tile)
        top = 2 ** (self.LEVELS - 1)
        if self.height % top:
            raise ValueError(f"height {self.height} is not divisible by {top}, as the CNM "
                             "conv stack's skips need")
        self.extents = [self.height >> lvl for lvl in range(self.LEVELS)]
        for lvl, n in enumerate(self.extents):
            if n < self.tile:
                raise ValueError(f"level 1/{2 ** lvl} has {n} rows, fewer than tile {self.tile}")
        self.ranges = [split_rows(n, self.tile) for n in self.extents]
        for stage in stages:
            for i in range(self.tile):
                self.check(stage[0], stage[2], self.stage_rows(stage, i), i)

    def rows(self, level: int, index: int) -> Rows:
        return self.ranges[level][index]

    def owner(self, level: int, row: int) -> int:
        """The tile index that holds global ``row`` of ``level``."""
        for i, (a, b) in enumerate(self.ranges[level]):
            if a <= row < b:
                return i
        raise ValueError(f"row {row} lies outside level 1/{2 ** level}'s {self.extents[level]}")

    def stage_rows(self, stage, index: int) -> Rows:
        """The input rows that tile ``index`` reads at ``stage``."""
        _, kind, lvl, k, stride = stage
        if kind == "conv":
            return conv_input_rows(self.rows(lvl + (stride == 2), index), k, stride)
        return upsample_input_rows(self.rows(lvl - 1, index), self.extents[lvl], kind)

    def check(self, stage: str, level: int, need: Rows, index: int) -> None:
        """Raise unless every row of ``need`` inside ``level`` is held by
        ``index`` or a neighbouring tile index."""
        lo, hi = max(need[0], 0), min(need[1], self.extents[level])
        if lo >= hi:
            return
        owners = {self.owner(level, lo), self.owner(level, hi - 1)}
        if max(abs(o - index) for o in owners) > 1:
            raise ValueError(
                f"{stage}: tile {index} of {self.tile} reads rows [{need[0]}, {need[1]}) at level "
                f"1/{2 ** level}, beyond its neighbours (rows per tile there: "
                f"{[b - a for a, b in self.ranges[level]]}); use a larger height or fewer tiles")


def least_height(tile: int) -> int:
    """The least image height whose ``RowPlan`` splits over ``tile``
    indices (32 at tile 1, 64 at tile 2): where the JAX package's
    partitioner shards any height, the port's row plan needs ``tile`` rows
    at every level."""
    height = 32
    while True:
        try:
            RowPlan(height, tile)
            return height
        except ValueError:
            height += 32


def local_batch_size(global_batch: int, mesh: Optional[Mesh] = None) -> int:
    """This process's share of ``global_batch`` (``global_batch`` over the
    process count, which must divide it), as in JAX."""
    count = dist.get_world_size() if _initialized() else 1
    per_proc = global_batch // count
    assert per_proc * count == global_batch
    return per_proc
