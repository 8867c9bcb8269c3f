"""Depth -> normals: the CUDA kernel's wrapper (forward only).

Replaces ``cnmnet_tpu/kernels/normals_pallas.py:depth_to_normal_pallas``
with the hand-written kernel in ``csrc/depth_to_normal.cu`` (its header
states the bound on an H100 and the design). The plain version is
``ops/normals.py``; ``depth_to_normal`` below takes it for CPU tensors only
and launches the kernel or raises for CUDA tensors. The points come from
the plain ``pixel2cam`` on either device.

The serving path needs no gradient, so a CUDA depth that requires one is
refused; the training slice adds the ``torch.autograd.Function``.

``depth_to_normal_kernel.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from cnmnet_tpu_torch.geometry.warp import pixel2cam
from cnmnet_tpu_torch.kernels import build
from cnmnet_tpu_torch.ops import normals as plain

MAX_K = 17
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [ctypes.c_void_p]


def depth_to_normal_kernel(
    depth: torch.Tensor,
    intrinsics_inv: torch.Tensor,
    k_size: int = 9,
    valid_min: float = 0.0,
    valid_max: float = 10.0,
    det_eps: float = 1e-5,
    norm_eps: float = 1e-5,
) -> torch.Tensor:
    """Launch the kernel: ``[B, H, W]`` f32 depth and ``[B, 3, 3]`` f32 K^-1,
    contiguous on one CUDA device -> unit normals ``[B, H, W, 3]`` f32.
    Does not synchronise."""
    if not depth.is_cuda:
        raise ValueError("depth_to_normal_kernel takes CUDA tensors")
    if depth.requires_grad or intrinsics_inv.requires_grad:
        raise ValueError("the depth->normal kernel has no backward yet")
    if depth.dim() != 3 or depth.dtype != torch.float32 or not depth.is_contiguous():
        raise ValueError(f"depth: want contiguous f32 [B, H, W], got {depth.dtype} {tuple(depth.shape)}")
    B, H, W = depth.shape
    if (tuple(intrinsics_inv.shape) != (B, 3, 3) or intrinsics_inv.dtype != torch.float32
            or intrinsics_inv.device != depth.device or not intrinsics_inv.is_contiguous()):
        raise ValueError(f"intrinsics_inv: want contiguous f32 ({B}, 3, 3) on {depth.device}")
    if k_size % 2 != 1 or not 1 <= k_size <= MAX_K:
        raise ValueError(f"k_size must be odd and at most {MAX_K}, got {k_size}")
    lib = build.load("depth_to_normal")
    fn = lib.cnm_depth_to_normal
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((B, H, W, 3), dtype=torch.float32, device=depth.device)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            depth.data_ptr(), intrinsics_inv.data_ptr(), out.data_ptr(), B, H, W, k_size,
            valid_min, valid_max, det_eps, norm_eps, stream,
        )
    build.check(status, "cnm_depth_to_normal")
    depth_to_normal_kernel.launches += 1
    return out


depth_to_normal_kernel.launches = 0


def depth_to_normal(depth: torch.Tensor, intrinsics_inv: torch.Tensor, k_size: int = 9):
    """(unit normals ``[B, H, W, 3]``, points ``[B, H, W, 3]``): the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    if not depth.is_cuda:
        return plain.depth_to_normal(depth, intrinsics_inv, k_size)
    normals = depth_to_normal_kernel(
        depth.float().contiguous(), intrinsics_inv.float().contiguous(), k_size
    )
    return normals, pixel2cam(depth, intrinsics_inv)
