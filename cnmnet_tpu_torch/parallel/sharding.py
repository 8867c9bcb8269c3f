"""Batch and row shards, and the collectives between them
(``cnmnet_tpu/parallel/sharding.py``).

The JAX module annotates shardings and lets GSPMD derive the collectives;
the port names them. Each contract is split into a pure per-shard function,
which the tests run for every shard in one process, and a wrapper that
runs the collective over one axis of a ``parallel/mesh.Mesh``:

* ``shard_batch``: this rank's samples of a global batch (``batch_shard``
  for shard ``i`` of ``n``). In JAX it returns the batch's placement; here
  each rank holds its own slice.
* ``shard_rows``: this rank's rows of the image fields of a batch
  (``batch_rows``), the port's ``constrain_spatial`` at the batch
  boundary: the fields and row dimensions that ``cnmnet_tpu/train/loop.py``
  puts on the "tile" axis.
* ``fetch_rows``: the one row exchange. A rank holds rows ``[start, stop)``
  of a map and needs rows ``[lo, hi)``; the rows it lacks come from the
  ranks that hold them, rows outside the map are zeros, and the backward
  sends the gradient of each fetched row back to its owner, which adds it
  to its own. The per-shard form is ``rows_from_shards``; ``fetch_table``
  holds the index arithmetic both share. A conv's halo, the reshard where
  an upsampled map meets a skip, and the whole-image gathers (the cost
  volume's and the warped-depth loss's source) are its cases. One
  ``all_gather`` over the tile group moves the rows (another one their
  gradients): each rank sends the rows the others need of it.
* ``shard_frames`` and ``gather_frames``: a batch of frames over the mesh
  and back (serving and evaluation: frames over "data", rows over
  "tile"; every rank ends with the whole batch's outputs).
* ``Spatial``: one rank's view of an image split over the tile axis: the
  ``mesh/RowPlan`` of its height, this rank's rows at each level, and the
  fetches and sums over the tile group. ``spatial_parallel`` points every
  windowed layer of a model at it, as ``data_parallel`` points the
  ``BatchNorm2d`` layers at a group.
* ``tile_partition_safe``: a copy of the JAX function (``sharding.py:41-69``),
  which guards an XLA partitioner miscompile of row-sharded convolutions.
  The port acts on it where the JAX package does (serving refuses, the CLI
  eval falls back to tile 1, training and eval warn); the port's own
  exchange is exact at any height its ``RowPlan`` accepts, and the plan
  refuses the rest.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from cnmnet_tpu_torch.parallel import collectives
from cnmnet_tpu_torch.parallel.mesh import (
    Mesh,
    RowPlan,
    Rows,
    conv_input_rows,
    upsample_input_rows,
)

# The JAX package's copy of the CNM conv schedule for ``tile_partition_safe``:
# (extent divisor, kernel, stride) per windowed stage whose input rows may
# ride the "tile" axis.
_CNM_TILE_STAGES = (
    (1, 7, 2), (2, 5, 2), (4, 3, 2), (8, 3, 2), (16, 3, 2),  # DepthNet enc
    (32, 3, 1),                                              # DepthNet dec
    (1, 3, 2), (2, 3, 2), (4, 3, 2),                         # RefineNet enc
    (8, 3, 1),                                               # RefineNet dec
)

# The row dimension of each image field of a batch (the others replicate
# over the tile axis): ``cnmnet_tpu/train/loop.py``'s ``h_dims``.
H_DIMS = {
    "images": 2,  # [B, V, H, W, 3]
    "depths": 2,  # [B, V, H, W]
    "disparity": 1,  # [B, H, W]
    "normals": 1,  # [B, H, W, 3]
    "instance_segs": 2,  # [B, S, H, W]
}


def tile_partition_safe(height: int, tile: int) -> Tuple[bool, str]:
    """The JAX package's rule for row-sharding ``height`` over ``tile``
    devices under GSPMD: per-shard extent at least ``2 (k - 1)`` at every
    stride-2 stage and ``k - 1`` at every stride-1 stage of the CNM
    schedule. Returns ``(safe, reason)``. It describes XLA's adjacent-shard
    halo exchange, not the port's (see the module docstring)."""
    if tile <= 1:
        return True, ""
    if height % tile:
        return False, f"height {height} not divisible by tile {tile}"
    for divisor, k, stride in _CNM_TILE_STAGES:
        extent = height // divisor
        need = 2 * (k - 1) if stride == 2 else (k - 1)
        if extent // tile < need:
            return False, (
                f"per-shard extent {extent}//{tile}={extent // tile} at the "
                f"1/{divisor}-res k={k} s={stride} conv is below the "
                f"GSPMD-halo-safe minimum {need} (adjacent-shard-only halo "
                f"exchange miscompiles silently; see parallel/sharding.py)"
            )
    return True, ""


# -- batches --------------------------------------------------------------------


def batch_shard(batch: Dict, index: int, count: int) -> Dict:
    """Samples ``[index * b, (index + 1) * b)`` of every field, ``b`` the
    global batch over ``count``, which must divide it."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % count:
            raise ValueError(f"{k!r}: batch of {n} does not split into {count} shards")
        b = n // count
        out[k] = v[index * b:(index + 1) * b]
    return out


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's data shard of a global ``batch`` (dim 0 over "data")."""
    return batch_shard(batch, mesh.data_index, mesh.data)


def batch_rows(batch: Dict, rows: Rows) -> Dict:
    """Rows ``[start, stop)`` of every image field of ``batch`` (``H_DIMS``);
    the other fields as they are."""
    a, b = rows
    return {k: v.narrow(H_DIMS[k], a, b - a) if k in H_DIMS else v for k, v in batch.items()}


def shard_rows(spatial: Optional["Spatial"], batch: Dict) -> Dict:
    """This rank's rows of the image fields of ``batch`` (None: all)."""
    return batch if spatial is None else batch_rows(batch, spatial.rows(0))


# -- the row fetch --------------------------------------------------------------


@functools.lru_cache(maxsize=512)
def fetch_table(ranges: Tuple[Rows, ...], needs: Tuple[Rows, ...], index: int):
    """The index arithmetic of one fetch, the same on every rank: tile index
    ``i`` holds rows ``ranges[i]`` of a map of ``ranges[-1][1]`` rows and
    needs rows ``needs[i]``. Returns ``(send, table, m)``:

    * ``send[j]``: the local rows of index ``j`` that other indices need,
      padded to ``m`` entries (the padding is never read);
    * ``table``: for each row ``index`` needs, its place in the pool
      ``[own rows, the m rows sent by index 0, ..., by index t - 1, a zero
      row]``."""
    t, extent = len(ranges), ranges[-1][1]
    starts = [a for a, _ in ranges]
    wanted = [set() for _ in range(t)]
    for i, (lo, hi) in enumerate(needs):
        for r in range(max(lo, 0), min(hi, extent)):
            j = bisect.bisect_right(starts, r) - 1
            if j != i:
                wanted[j].add(r - starts[j])
    send = [sorted(w) for w in wanted]
    m = max(1, max(len(s) for s in send))
    pos = [{row: p for p, row in enumerate(s)} for s in send]
    send = tuple(tuple(s + [s[-1] if s else 0] * (m - len(s))) for s in send)
    own = ranges[index][1] - ranges[index][0]
    zero = own + t * m
    table = []
    for r in range(*needs[index]):
        if not 0 <= r < extent:
            table.append(zero)
            continue
        j = bisect.bisect_right(starts, r) - 1
        local = r - starts[j]
        table.append(local if j == index else own + j * m + pos[j][local])
    return send, tuple(table), m


def rows_from_shards(shards: Sequence[torch.Tensor], ranges: Sequence[Rows], need: Rows,
                     dim: int) -> torch.Tensor:
    """Rows ``need`` of the map whose shards are ``shards`` (held rows
    ``ranges``), zeros outside it: the per-shard form of ``fetch_rows``, a
    differentiable function of every shard."""
    whole = torch.cat(list(shards), dim)
    zero = whole.new_zeros(whole.narrow(dim, 0, 1).shape)
    pool = torch.cat([whole, zero], dim)
    extent = ranges[-1][1]
    index = [r if 0 <= r < extent else extent for r in range(*need)]
    return pool.index_select(dim, torch.tensor(index, device=whole.device))


class _RowFetch(torch.autograd.Function):
    """The collective of ``fetch_rows``: one ``all_gather`` of the rows each
    rank sends; the backward gathers each rank's gradients of the rows it
    fetched and adds them to their owners' rows."""

    @staticmethod
    def forward(ctx, x, send, table, m, index, group, dim):
        dev = x.device
        send_t = torch.tensor(send[index], device=dev)
        table_t = torch.tensor(table, device=dev)
        mine = x.index_select(dim, send_t)
        parts = [mine] if group is None else collectives.all_gather(mine, group)
        zero = x.new_zeros(x.narrow(dim, 0, 1).shape)
        pool = torch.cat([x] + parts + [zero], dim)
        ctx.save_for_backward(send_t, table_t)
        ctx.meta = (x.shape[dim], len(parts), m, index, group, dim, pool.shape)
        return pool.index_select(dim, table_t)

    @staticmethod
    def backward(ctx, grad):
        send_t, table_t = ctx.saved_tensors
        own, t, m, index, group, dim, pool_shape = ctx.meta
        g_pool = grad.new_zeros(pool_shape).index_add_(dim, table_t, grad)
        gx = g_pool.narrow(dim, 0, own)
        if group is not None:
            owed = collectives.all_gather(g_pool.narrow(dim, own, t * m), group)
            back = owed[0].narrow(dim, index * m, m)
            for o in owed[1:]:
                back = back + o.narrow(dim, index * m, m)
            gx = gx.index_add(dim, send_t, back)
        return gx, None, None, None, None, None, None


def fetch_rows(x: torch.Tensor, ranges: Sequence[Rows], needs: Sequence[Rows], index: int,
               group, dim: int) -> torch.Tensor:
    """Rows ``needs[index]`` of a map of which this rank, tile index
    ``index`` of the ranks of ``group``, holds ``x``, rows
    ``ranges[index]`` along ``dim``; every rank of the group calls it with
    the same ``ranges`` and ``needs``. Zeros outside the map; a gradient
    flows back to each row's owner. ``group`` None: one rank."""
    send, table, m = fetch_table(tuple(map(tuple, ranges)), tuple(map(tuple, needs)), index)
    return _RowFetch.apply(x, send, table, m, index, group, dim)


# -- a rank's rows of an image ------------------------------------------------------


class Spatial:
    """This rank's rows of a ``height`` x ``width`` image split over the
    tile axis of ``mesh`` (``RowPlan(height, mesh.tile)``). A map's level
    is read from its width, which no shard splits: a map ``width / 2^L``
    wide is at level L, and its rows here are ``rows(L)``."""

    def __init__(self, mesh: Mesh, height: int, width: int):
        self.mesh, self.height, self.width = mesh, int(height), int(width)
        self.plan = RowPlan(height, mesh.tile)
        self.index = mesh.tile_index
        self.group = mesh.tile_group if mesh.tile > 1 else None
        if mesh.tile > 1 and self.group is None:
            raise ValueError("a tile axis above 1 needs the mesh's process groups (make_mesh)")

    @classmethod
    def for_mesh(cls, mesh: Optional[Mesh], height: int, width: int) -> Optional["Spatial"]:
        """The view of a mesh with a tile axis above 1, else None."""
        return cls(mesh, height, width) if mesh is not None and mesh.tile > 1 else None

    def rows(self, level: int) -> Rows:
        return self.plan.rows(level, self.index)

    def level(self, width: int) -> int:
        lvl = max(self.width // max(width, 1), 1).bit_length() - 1
        if width << lvl != self.width:
            raise ValueError(f"a map {width} wide is no level of a {self.width}-wide image")
        return lvl

    def fetch(self, x: torch.Tensor, level: int, need_of, stage: str, dim: int) -> torch.Tensor:
        """Rows ``need_of(i)`` of this level's map for this rank (``x``, its
        rows of it); ``need_of`` gives every tile index's need. A row
        beyond a neighbour raises ``ValueError`` naming ``stage``."""
        ranges = self.plan.ranges[level]
        needs = [need_of(i) for i in range(self.plan.tile)]
        for i, need in enumerate(needs):
            self.plan.check(stage, level, need, i)
        return fetch_rows(x, ranges, needs, self.index, self.group, dim)

    def gather(self, x: torch.Tensor, level: int = 0, dim: int = 1) -> torch.Tensor:
        """Every row of this level's map on every rank (``x``: this rank's)."""
        extent = self.plan.extents[level]
        return fetch_rows(x, self.plan.ranges[level], [(0, extent)] * self.plan.tile,
                          self.index, self.group, dim)

    def conv_input(self, x: torch.Tensor, k: int, stride: int, stage: str) -> torch.Tensor:
        """The NCHW input rows a size-``k``, stride-``stride`` conv reads
        for this rank's output rows, its H padding included as zero rows."""
        lvl = self.level(x.shape[-1])
        out = lvl + (stride == 2)
        return self.fetch(x, lvl, lambda i: conv_input_rows(self.plan.rows(out, i), k, stride),
                          stage, 2)

    def upsample_input(self, x: torch.Tensor, mode: str, stage: str):
        """``(rows, first)``: the NCHW input rows whose x2 upsampling holds
        this rank's rows of the finer level exactly, and the first of them."""
        lvl = self.level(x.shape[-1])
        n = self.plan.extents[lvl]
        need = lambda i: upsample_input_rows(self.plan.rows(lvl - 1, i), n, mode)  # noqa: E731
        return self.fetch(x, lvl, need, stage, 2), need(self.index)[0]

    def subsample(self, x: torch.Tensor, factor: int, dim: int = 1) -> torch.Tensor:
        """The rows whose global index is a multiple of ``factor`` (level
        ``log2 factor``'s rows here) of a full-resolution map, ``x`` this
        rank's rows of it (``gt[:, ::f]`` on the whole image)."""
        lvl = factor.bit_length() - 1
        need = lambda i: (factor * self.plan.rows(lvl, i)[0],  # noqa: E731
                          factor * (self.plan.rows(lvl, i)[1] - 1) + 1)
        rows = self.fetch(x, 0, need, f"ground truth at 1/{factor}", dim)
        return rows.index_select(dim, torch.arange(0, rows.shape[dim], factor, device=x.device))

    def tile_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the tile group, with a gradient."""
        return collectives.group_sum(x, self.group)


def shard_frames(mesh: Mesh, images: torch.Tensor, cams: torch.Tensor):
    """``(spatial, images, cams)``: this rank's frames of a batch (over
    "data") and rows of its images ``[B, V, H, W, 3]`` (over "tile"), with
    the ``Spatial`` of those rows (None without a tile axis)."""
    images, cams = (batch_shard({"i": images, "c": cams}, mesh.data_index, mesh.data)[k]
                    for k in ("i", "c"))
    spatial = Spatial.for_mesh(mesh, images.shape[2], images.shape[3])
    if spatial is not None:
        a, b = spatial.rows(0)
        images = images[:, :, a:b]
    return spatial, images, cams


def gather_frames(mesh: Mesh, spatial: Optional[Spatial], x: torch.Tensor) -> torch.Tensor:
    """The whole batch ``[B, H, ...]`` on every rank of ``mesh`` from each
    rank's frames and rows ``[b, h, ...]`` (``shard_frames``'s inverse)."""
    if spatial is not None:
        x = spatial.gather(x, 0, dim=1)
    if mesh.data > 1:
        x = torch.cat(collectives.all_gather(x, mesh.data_group), 0)
    return x


@contextlib.contextmanager
def data_parallel(model: torch.nn.Module, group):
    """Within the block, every port ``BatchNorm2d`` of ``model`` takes its
    train-mode statistics over ``group`` (None: unchanged): the data group
    of a data mesh, the whole mesh's group under a tile axis."""
    from cnmnet_tpu_torch.models.layers import BatchNorm2d

    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.group = group
    try:
        yield model
    finally:
        for m in norms:
            m.group = None


@contextlib.contextmanager
def spatial_parallel(model: torch.nn.Module, spatial: Optional[Spatial]):
    """Within the block, every module of ``model`` that works on rows (the
    port's ``Conv2d``, ``Upsample2x``, ``GroupNormF32``, the DepthNet's
    nearest upsamplings and the ``CNMModel``'s cost volume) works on this
    rank's rows of ``spatial`` (None: unchanged)."""
    if spatial is None:
        yield model
        return
    mods = [m for m in model.modules() if hasattr(m, "spatial")]
    for m in mods:
        m.spatial = spatial
    try:
        yield model
    finally:
        for m in mods:
            m.spatial = None
