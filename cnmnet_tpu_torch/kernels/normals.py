"""Depth -> normals: the CUDA kernel's wrapper and its gradient.

Replaces ``cnmnet_tpu/kernels/normals_pallas.py:depth_to_normal_pallas``
with the hand-written kernel in ``csrc/depth_to_normal.cu`` (its header
states the bound on an H100 and the design). The plain version is
``ops/normals.py``; ``depth_to_normal`` below takes it for CPU tensors only
and launches the kernel or raises for CUDA tensors. The points come from
the plain ``pixel2cam`` on either device.

Where a gradient is needed, the kernel runs inside ``DepthToNormal``, whose
backward is autograd through the plain version, recomputed from the saved
inputs: the JAX kernel's ``custom_vjp`` (``_fwd``/``_bwd``) does the same,
and neither package has a backward kernel.

Every odd k launches: up to ``UNROLLED_K`` an instance unrolled for its
k, above it one k-generic instance whose shared memory (``shared_bytes``)
does not depend on k. A launch takes at most ``MAX_BATCH`` maps (the CUDA
grid's z extent); the wrapper splits a larger batch (``batch_chunks``).

``depth_to_normal_kernel.launches`` counts the kernel's launches: one per
chunk of ``batch_chunks``.
"""

from __future__ import annotations

import ctypes

import torch

from cnmnet_tpu_torch.geometry.warp import pixel2cam
from cnmnet_tpu_torch.kernels import build
from cnmnet_tpu_torch.ops import normals as plain

UNROLLED_K = 17  # csrc/depth_to_normal.cu:kMaxK
TILE_W, TILE_H = 64, 8  # the kernel's output tile
PIECE_W = 128  # staged columns a piece of the k-generic instance
MAX_BATCH = 65535  # maps a launch: csrc/depth_to_normal.cu:kMaxBatch
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4 + [ctypes.c_void_p]


def shared_bytes(k_size: int) -> int:
    """Dynamic shared memory of one block at an odd window ``k_size``
    (``csrc/depth_to_normal.cu:shared_bytes``). Unrolled instances: the
    staged points X, Y, Z of the tile and its halo, then the raw depth or
    the 9 x ``TILE_H`` rows of vertical sums, whichever is larger; rows
    padded to 16 bytes. The k-generic instance: one piece's 9 x ``TILE_H``
    x ``PIECE_W`` vertical sums, at any k."""
    if k_size > UNROLLED_K:
        return 9 * TILE_H * PIECE_W * 4
    r = k_size // 2
    pitch = (TILE_W + 2 * r + 3) // 4 * 4
    stage = (TILE_H + 2 * r) * pitch
    return (3 * stage + max(stage, 9 * TILE_H * pitch)) * 4


def batch_chunks(B: int) -> list:
    """``[(b0, b1), ...]``: the launches that cover ``B`` maps, in order,
    each of at most ``MAX_BATCH``."""
    return [(b, min(b + MAX_BATCH, B)) for b in range(0, B, MAX_BATCH)]


def depth_to_normal_kernel(
    depth: torch.Tensor,
    intrinsics_inv: torch.Tensor,
    k_size: int = 9,
    valid_min: float = 0.0,
    valid_max: float = 10.0,
    det_eps: float = 1e-5,
    norm_eps: float = 1e-5,
    row_offset: int = 0,
) -> torch.Tensor:
    """Launch the kernel: ``[B, H, W]`` f32 depth (rows from global row
    ``row_offset`` on) and ``[B, 3, 3]`` f32 K^-1, contiguous on one CUDA
    device -> unit normals ``[B, H, W, 3]`` f32, in one launch for each
    chunk of ``batch_chunks(B)``. Does not synchronise."""
    if not depth.is_cuda:
        raise ValueError("depth_to_normal_kernel takes CUDA tensors")
    if depth.dim() != 3 or depth.dtype != torch.float32 or not depth.is_contiguous():
        raise ValueError(f"depth: want contiguous f32 [B, H, W], got {depth.dtype} {tuple(depth.shape)}")
    B, H, W = depth.shape
    if (tuple(intrinsics_inv.shape) != (B, 3, 3) or intrinsics_inv.dtype != torch.float32
            or intrinsics_inv.device != depth.device or not intrinsics_inv.is_contiguous()):
        raise ValueError(f"intrinsics_inv: want contiguous f32 ({B}, 3, 3) on {depth.device}")
    if k_size % 2 != 1 or k_size < 1:
        raise ValueError(f"k_size must be odd and positive, got {k_size}")
    lib = build.load("depth_to_normal")
    fn = lib.cnm_depth_to_normal
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((B, H, W, 3), dtype=torch.float32, device=depth.device)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0, b1 in batch_chunks(B):
            status = fn(
                depth[b0:b1].data_ptr(), intrinsics_inv[b0:b1].data_ptr(), out[b0:b1].data_ptr(),
                b1 - b0, H, W, k_size, row_offset, valid_min, valid_max, det_eps, norm_eps, stream,
            )
            build.check(status, "cnm_depth_to_normal")
            depth_to_normal_kernel.launches += 1
    return out


depth_to_normal_kernel.launches = 0


class DepthToNormal(torch.autograd.Function):
    """``depth_to_normal_kernel`` forward; backward = autograd through the
    plain ``ops/normals.depth_to_normal`` on the saved inputs, for ``depth``
    and, where it requires one, ``intrinsics_inv``. Types are the caller's:
    the wrapper below hands it f32."""

    @staticmethod
    def forward(ctx, depth, intrinsics_inv, k_size, row_offset=0):
        ctx.save_for_backward(depth, intrinsics_inv)
        ctx.k_size, ctx.row_offset = k_size, row_offset
        return depth_to_normal_kernel(depth.detach().contiguous(),
                                      intrinsics_inv.detach().contiguous(), k_size,
                                      row_offset=row_offset)

    @staticmethod
    def backward(ctx, grad_normals):
        depth, intrinsics_inv = ctx.saved_tensors
        needs = ctx.needs_input_grad[:2]
        with torch.profiler.record_function("depth_to_normal_backward"), torch.enable_grad():
            d = depth.detach().requires_grad_(needs[0])
            ki = intrinsics_inv.detach().requires_grad_(needs[1])
            normals, _ = plain.depth_to_normal(d, ki, ctx.k_size, row_offset=ctx.row_offset)
            wrt = [t for t, n in zip((d, ki), needs) if n]
            grads = iter(torch.autograd.grad(normals, wrt, grad_normals))
        return tuple(next(grads) if n else None for n in needs) + (None, None)


def depth_to_normal(depth: torch.Tensor, intrinsics_inv: torch.Tensor, k_size: int = 9,
                    row_offset: int = 0):
    """(unit normals ``[B, H, W, 3]``, points ``[B, H, W, 3]``) of the depth
    rows from global row ``row_offset`` on: the plain version for CPU
    tensors; for CUDA tensors the kernel, inside ``DepthToNormal`` where a
    gradient is needed (the cast to f32 is part of the graph, so the
    gradient returns in the caller's dtype)."""
    if not depth.is_cuda:
        return plain.depth_to_normal(depth, intrinsics_inv, k_size, row_offset=row_offset)
    d, ki = depth.float(), intrinsics_inv.float()
    if torch.is_grad_enabled() and (d.requires_grad or ki.requires_grad):
        normals = DepthToNormal.apply(d, ki, k_size, row_offset)
    else:
        normals = depth_to_normal_kernel(d.contiguous(), ki.contiguous(), k_size,
                                         row_offset=row_offset)
    return normals, pixel2cam(depth, intrinsics_inv, row_offset)
