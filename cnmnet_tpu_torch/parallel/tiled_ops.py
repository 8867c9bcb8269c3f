"""Row-tiled depth->normal and cost volume (``cnmnet_tpu/parallel/tiled_ops.py``).

An image's rows split over the mesh's "tile" axis: each rank holds ``h =
H / tile`` consecutive rows from global row ``tile_index * h``. The
contract is the JAX module's: each op is bit-equal to the untiled op.
Both run the hand kernels on CUDA tensors with a global row offset, and the
plain versions with the same offset on CPU tensors:

* ``depth_to_normal_tiled`` exchanges ``k // 2`` *depth* rows with the ring
  neighbours (zero rows at the global border) and runs the op on the ``h +
  2 halo`` rows from global row ``row_offset - halo``, keeping the interior
  ``h``. A zero depth row gives zero monomials whatever ``valid_min`` is
  (its points are ``ray * 0``), so it stands for the zero padding of the
  untiled box sum as the JAX exchange of zero monomial rows does; every
  window sum adds its taps first to last from 0, so the sums do not depend
  on where the shard starts. The extra rows cost ``2 halo / h`` more work.
* ``cost_volume_tiled`` all-gathers the source rows over the tile axis;
  the reference rows stay local and sample the whole source through their
  global pixel coordinates. The JAX op takes the per-pixel terms; the port
  takes the cameras, as ``kernels/dispatch.cost_volume`` does, and the
  kernel forms each pixel's terms itself.

``*_shard`` are the per-shard computations, given what the collectives
bring; the tests run them for every shard in one process. No gradient
crosses the exchange: the tiled ops are forward only.
"""

from __future__ import annotations

import torch

from cnmnet_tpu_torch.kernels import dispatch
from cnmnet_tpu_torch.parallel.mesh import Mesh
from cnmnet_tpu_torch.parallel.sharding import all_gather_rows, halo_exchange_rows


def depth_to_normal_shard(depth_halo: torch.Tensor, intrinsics_inv: torch.Tensor,
                          row_offset: int, halo: int, k_size: int = 9,
                          backend=None) -> torch.Tensor:
    """Normals ``[B, h, W, 3]`` of the ``h`` rows from global row
    ``row_offset``, from their depth with ``halo`` rows above and below
    (``depth_halo`` ``[B, h + 2 halo, W]``)."""
    normals, _ = dispatch.depth_to_normal(depth_halo, intrinsics_inv, k_size, backend=backend,
                                          row_offset=row_offset - halo)
    return normals[:, halo:depth_halo.shape[1] - halo]


def depth_to_normal_tiled(depth: torch.Tensor, intrinsics_inv: torch.Tensor, mesh: Mesh,
                          k_size: int = 9, backend=None) -> torch.Tensor:
    """This rank's depth rows ``[B, h, W]`` (``K^-1`` ``[B, 3, 3]``) ->
    their normals ``[B, h, W, 3]``, equal to those rows of the untiled
    ``depth_to_normal``. ``h`` must be at least ``k // 2``."""
    halo = k_size // 2
    h = depth.shape[1]
    with torch.no_grad():
        depth_halo = halo_exchange_rows(depth, halo, mesh, dim=-2) if halo else depth
        return depth_to_normal_shard(depth_halo, intrinsics_inv, mesh.tile_index * h, halo,
                                     k_size, backend)


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
                      mesh: Mesh, idepth_scale: float = 3.0, num_planes: int = 64,
                      backend=None, sampling: str = "exact", out_dtype=None) -> torch.Tensor:
    """This rank's rows of the reference and source images ``[B, h, W, 3]``
    and the pairs' cameras -> its rows of the cost volume ``[B, h, W, P]``,
    equal to those rows of the untiled volume."""
    h = ref_images.shape[1]
    with torch.no_grad():
        src_full = all_gather_rows(src_images, mesh, dim=1)
        return cost_volume_shard(ref_images, src_full, ref_cam, src_cam, mesh.tile_index * h,
                                 idepth_scale, num_planes, backend, sampling, out_dtype)
