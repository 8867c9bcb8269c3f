"""Batch and row shards, and the collectives between them
(``cnmnet_tpu/parallel/sharding.py``).

The JAX module annotates shardings and lets GSPMD derive the collectives;
the port names them. Each contract is split into a pure per-shard function,
which the tests run for every shard in one process, and a wrapper that
runs the collective over one axis of a ``parallel/mesh.Mesh``:

* ``shard_batch``: this rank's samples of a global batch (``batch_shard``
  for shard ``i`` of ``n``). In JAX it returns the batch's placement; here
  each rank holds its own slice.
* ``halo_exchange_rows``: a row shard with ``halo`` rows of each ring
  neighbour, zero rows at the global image border (``halo_rows`` from
  given neighbour rows, ``edge_rows`` for what a shard sends). The wrapper
  all-gathers every shard's two edges over the tile group. No gradient
  crosses it.
* ``data_parallel``: points a model's ``BatchNorm2d`` layers at the data
  group for one step. The sums over that group that BatchNorm and the
  losses take are ``parallel/collectives.py``'s.

``tile_partition_safe`` (``sharding.py:41-69``) guards an XLA partitioner
miscompile of row-sharded convolutions and has no counterpart here.
``constrain_spatial`` waits for the port's tile axis through the conv
stack (ROADMAP).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from cnmnet_tpu_torch.parallel.mesh import Mesh


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


def edge_rows(x: torch.Tensor, halo: int, dim: int = -3) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first and the last ``halo`` rows of a shard along ``dim``: what
    it sends to the shard above and to the shard below."""
    n = x.shape[dim]
    if not 0 < halo <= n:
        raise ValueError(f"halo {halo} must be between 1 and the shard's {n} rows")
    return x.narrow(dim, 0, halo), x.narrow(dim, n - halo, halo)


def halo_rows(x: torch.Tensor, above: Optional[torch.Tensor], below: Optional[torch.Tensor],
              halo: int, dim: int = -3) -> torch.Tensor:
    """``[above, x, below]`` along ``dim``; a missing neighbour (None: the
    global image border) gives ``halo`` zero rows."""
    shape = list(x.shape)
    shape[dim] = halo
    zeros = x.new_zeros(shape)
    return torch.cat([zeros if above is None else above, x,
                      zeros if below is None else below], dim)


def halo_exchange_rows(x: torch.Tensor, halo: int, mesh: Mesh, dim: int = -3) -> torch.Tensor:
    """This rank's row shard with ``halo`` rows from each neighbour along the
    tile axis (the bottom rows of the shard above, the top rows of the
    shard below; zeros at the global border): ``[..., h + 2 halo, ...]``."""
    n, idx = mesh.tile, mesh.tile_index
    if n == 1:
        return halo_rows(x, None, None, halo, dim)
    top, bottom = edge_rows(x, halo, dim)
    mine = torch.stack([top, bottom]).contiguous()
    edges = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(edges, mine, group=mesh.tile_group)
    above = edges[idx - 1][1] if idx > 0 else None
    below = edges[idx + 1][0] if idx < n - 1 else None
    return halo_rows(x, above, below, halo, dim)


def all_gather_rows(x: torch.Tensor, mesh: Mesh, dim: int = -3) -> torch.Tensor:
    """Every tile shard's rows, concatenated along ``dim`` in tile order."""
    if mesh.tile == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.tile)]
    dist.all_gather(parts, x.contiguous(), group=mesh.tile_group)
    return torch.cat(parts, dim)


@contextlib.contextmanager
def data_parallel(model: torch.nn.Module, group):
    """Within the block, every port ``BatchNorm2d`` of ``model`` takes its
    train-mode statistics over ``group`` (None: unchanged)."""
    from cnmnet_tpu_torch.models.layers import BatchNorm2d

    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.group = group
    try:
        yield model
    finally:
        for m in norms:
            m.group = None
