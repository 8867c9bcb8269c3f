"""Kernel backend dispatch: plain PyTorch versions vs the CUDA kernels.

Every op with a kernel has two implementations: ``"torch"``, the plain
version in ``ops/`` (source of truth for tests, the CPU path, autograd),
and ``"cuda"``, the hand-written kernel in ``kernels/``.

Selection (the policy of ``cnmnet_tpu/kernels/dispatch.py``):

* ``backend=None`` (auto): the kernel for CUDA tensors, the plain version
  for CPU tensors;
* ``backend="cuda"``: the kernel; CPU tensors raise;
* ``backend="torch"``: the plain version on either device, for tests and
  the kernel-vs-plain checks.

A kernel that cannot build or launch raises; nothing falls back.

Unlike the JAX package, whose TPU dispatch demoted the depth->normal
kernel, auto selects the depth->normal kernel on CUDA.
"""

from __future__ import annotations

import torch

from cnmnet_tpu_torch.kernels import cost_volume as _cv_kernel
from cnmnet_tpu_torch.kernels import normals as _normal_kernel
from cnmnet_tpu_torch.ops import cost_volume as _cv_ops
from cnmnet_tpu_torch.ops import normals as _normal_ops

BACKENDS = (None, "torch", "cuda")


def _resolve(backend, tensor: torch.Tensor) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend is None:
        return "cuda" if tensor.is_cuda else "torch"
    if backend == "cuda" and not tensor.is_cuda:
        raise ValueError(f"backend 'cuda' was requested for tensors on {tensor.device}")
    return backend


def cost_volume(ref_images, src_images, ref_cam, src_cam, idepth_scale=3.0,
                num_planes=64, backend=None, sampling="exact", out_dtype=None,
                row_offset=0):
    """Batched plane-sweep cost volume ``[B, H, W, P]`` (see ops.cost_volume).

    out_dtype: the volume's type (default f32); the cost accumulates in f32
    and only the writeback rounds.

    row_offset: the global row of the first of ``ref_images``' rows, for a
    row shard against the whole source (``parallel/tiled_ops.py``); 0 when
    both images are whole.

    sampling: "exact" samples the source at the pinhole projection u;
    "torch" reproduces the reference's grid_sample convention, which lands
    at u (S-1)/S, by prescaling the source intrinsics (same math on every
    backend).
    """
    if sampling == "torch":
        H, W = src_images.shape[1], src_images.shape[2]
        s = src_cam.intrinsic.new_tensor([(W - 1) / W, (H - 1) / H, 1.0])[:, None]
        src_cam = src_cam._replace(intrinsic=src_cam.intrinsic * s)
    elif sampling != "exact":
        raise ValueError(f"unknown sampling convention {sampling!r}")
    out_dtype = out_dtype or torch.float32
    if _resolve(backend, ref_images) == "cuda":
        return _cv_kernel.cost_volume(ref_images, src_images, ref_cam, src_cam,
                                      idepth_scale, num_planes, out_dtype, row_offset)
    vol = _cv_ops.cost_volume_from_cameras(ref_images, src_images, ref_cam, src_cam,
                                           idepth_scale, num_planes, row_offset)
    return vol.to(out_dtype)


def depth_to_normal(depth, intrinsics_inv, k_size=9, backend=None, row_offset=0):
    """Depth -> (unit normals ``[B, H, W, 3]``, points); see ops.normals.
    ``row_offset``: the global row of ``depth``'s first row (a row shard)."""
    if _resolve(backend, depth) == "cuda":
        return _normal_kernel.depth_to_normal(depth, intrinsics_inv, k_size, row_offset)
    return _normal_ops.depth_to_normal(depth, intrinsics_inv, k_size, row_offset=row_offset)


def launch_counts() -> dict:
    """Each kernel's launch counter in this process (``*_kernel.launches``):
    what a rank process reports back to the process that started it."""
    return {"cost_volume": _cv_kernel.cost_volume_kernel.launches,
            "depth_to_normal": _normal_kernel.depth_to_normal_kernel.launches}
