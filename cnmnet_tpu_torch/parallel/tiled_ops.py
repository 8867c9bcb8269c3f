"""Row-tiled depth->normal and cost volume (``cnmnet_tpu/parallel/tiled_ops.py``).

An image's rows split over the mesh's "tile" axis as its
``parallel/mesh.RowPlan`` says: this rank holds rows ``[start, stop)`` of
level 0 (``Spatial.rows(0)``). The contract is the JAX module's: each op
is bit-equal to the untiled op. Both run the hand kernels on CUDA tensors
with a global row offset, and the plain versions with the same offset on
CPU tensors:

* ``depth_to_normal_tiled`` fetches ``k // 2`` *depth* rows above and below
  from the neighbours (zero rows at the global border;
  ``sharding.fetch_rows``) and runs the op on those rows from global row
  ``start - halo``, keeping the interior. A zero depth row gives zero
  monomials whatever ``valid_min`` is (its points are ``ray * 0``), so it
  stands for the zero padding of the untiled box sum as the JAX exchange of
  zero monomial rows does; every window sum adds its taps first to last
  from 0, so the sums do not depend on where the shard starts. The extra
  rows cost ``2 halo / h`` more work. The gradient crosses the halo: the
  fetch's backward returns each halo row's gradient to the rank that holds
  the row, which adds it to its own (the normal loss needs it).
* ``cost_volume_tiled`` gathers the whole source over the tile axis; the
  reference rows stay local and sample the whole source through their
  global pixel coordinates. It has no gradient, as ``stop_gradient`` leaves
  the JAX op. The JAX op takes the per-pixel terms; the port takes the
  cameras, as ``kernels/dispatch.cost_volume`` does, and the kernel forms
  each pixel's terms itself.

``*_shard`` are the per-shard computations, given what the fetches bring;
the tests run them for every shard in one process.
"""

from __future__ import annotations

import torch

from cnmnet_tpu_torch.kernels import dispatch
from cnmnet_tpu_torch.parallel.sharding import Spatial


def depth_to_normal_shard(depth_halo: torch.Tensor, intrinsics_inv: torch.Tensor,
                          row_offset: int, halo: int, k_size: int = 9,
                          backend=None) -> torch.Tensor:
    """Normals ``[B, h, W, 3]`` of the ``h`` rows from global row
    ``row_offset``, from their depth with ``halo`` rows above and below
    (``depth_halo`` ``[B, h + 2 halo, W]``)."""
    normals, _ = dispatch.depth_to_normal(depth_halo, intrinsics_inv, k_size, backend=backend,
                                          row_offset=row_offset - halo)
    return normals[:, halo:depth_halo.shape[1] - halo]


def depth_to_normal_tiled(depth: torch.Tensor, intrinsics_inv: torch.Tensor, spatial: Spatial,
                          k_size: int = 9, backend=None) -> torch.Tensor:
    """This rank's depth rows ``[B, h, W]`` (``K^-1`` ``[B, 3, 3]``) ->
    their normals ``[B, h, W, 3]``, equal to those rows of the untiled
    ``depth_to_normal``, with a gradient to every depth row it read."""
    halo = k_size // 2
    start = spatial.rows(0)[0]
    depth_halo = spatial.fetch(
        depth, 0, lambda i: (spatial.plan.rows(0, i)[0] - halo, spatial.plan.rows(0, i)[1] + halo),
        f"depth->normal halo (k={k_size})", 1)
    return depth_to_normal_shard(depth_halo, intrinsics_inv, start, halo, k_size, backend)


def cost_volume_shard(ref_rows: torch.Tensor, src_images: torch.Tensor, ref_cam, src_cam,
                      row_offset: int, idepth_scale: float = 3.0, num_planes: int = 64,
                      backend=None, sampling: str = "exact", out_dtype=None) -> torch.Tensor:
    """The cost volume ``[B, h, W, P]`` of the reference rows ``[B, h, W, 3]``
    from global row ``row_offset`` against the whole source ``[B, H, W,
    3]``."""
    return dispatch.cost_volume(ref_rows, src_images, ref_cam, src_cam, idepth_scale, num_planes,
                                backend=backend, sampling=sampling, out_dtype=out_dtype,
                                row_offset=row_offset)


def cost_volume_tiled(ref_images: torch.Tensor, src_images: torch.Tensor, ref_cam, src_cam,
                      spatial: Spatial, idepth_scale: float = 3.0, num_planes: int = 64,
                      backend=None, sampling: str = "exact", out_dtype=None) -> torch.Tensor:
    """This rank's rows of the reference and source images ``[B, h, W, 3]``
    and the pairs' cameras -> its rows of the cost volume ``[B, h, W, P]``,
    equal to those rows of the untiled volume."""
    with torch.no_grad():
        src_full = spatial.gather(src_images, 0, dim=1)
        return cost_volume_shard(ref_images, src_full, ref_cam, src_cam, spatial.rows(0)[0],
                                 idepth_scale, num_planes, backend, sampling, out_dtype)
