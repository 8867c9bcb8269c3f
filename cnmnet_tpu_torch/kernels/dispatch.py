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

The bilinear x2 upsampling kernel has no backward and reads channels-last
maps only, so off ``"torch"`` it takes what it can take (a channels-last
CUDA map of bf16 or f32, channels a multiple of 8, that needs no gradient:
the one-card serving nets) and every other map on the card keeps the plain
version (the trainer, evaluation and a mesh run NCHW).
"""

from __future__ import annotations

import torch

from cnmnet_tpu_torch.kernels import cost_volume as _cv_kernel
from cnmnet_tpu_torch.kernels import normals as _normal_kernel
from cnmnet_tpu_torch.kernels import upsample as _upsample_kernel
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
                row_offset=0, volume_out=None):
    """Batched plane-sweep cost volume ``[B, H, W, P]`` (see ops.cost_volume).

    out_dtype: the volume's type (default f32); the cost accumulates in f32
    and only the writeback rounds.

    row_offset: the global row of the first of ``ref_images``' rows, for a
    row shard against the whole source (``parallel/tiled_ops.py``); 0 when
    both images are whole.

    volume_out: a ``[B, P, H, W]`` tensor of ``out_dtype`` to write the
    volume into (contiguous for the kernel); the result is then a view of it.

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
                                      idepth_scale, num_planes, out_dtype, row_offset,
                                      volume_out)
    vol = _cv_ops.cost_volume_from_cameras(ref_images, src_images, ref_cam, src_cam,
                                           idepth_scale, num_planes, row_offset)
    return _cv_kernel.written_into(vol.to(out_dtype), volume_out)


def depth_to_normal(depth, intrinsics_inv, k_size=9, backend=None, row_offset=0):
    """Depth -> (unit normals ``[B, H, W, 3]``, points); see ops.normals.
    ``row_offset``: the global row of ``depth``'s first row (a row shard)."""
    if _resolve(backend, depth) == "cuda":
        return _normal_kernel.depth_to_normal(depth, intrinsics_inv, k_size, row_offset)
    return _normal_ops.depth_to_normal(depth, intrinsics_inv, k_size, row_offset=row_offset)


def upsample2x_bilinear(x, backend=None):
    """Bilinear x2 upsampling with half-pixel centres of a ``[N, C, H, W]``
    map (``kernels/upsample.py``)."""
    if (_resolve(backend, x) == "cuda" and x.dtype in _upsample_kernel.DTYPES
            and x.dim() == 4 and x.shape[1] % _upsample_kernel.CHANNEL_MULTIPLE == 0
            and x.is_contiguous(memory_format=torch.channels_last)
            and not (torch.is_grad_enabled() and x.requires_grad)):
        return _upsample_kernel.upsample2x_bilinear_kernel(x)
    return _upsample_kernel.upsample2x_bilinear_plain(x)


def launch_counts() -> dict:
    """Each kernel's launch counter in this process (``*_kernel.launches``):
    what a rank process reports back to the process that started it."""
    return {"cost_volume": _cv_kernel.cost_volume_kernel.launches,
            "depth_to_normal": _normal_kernel.depth_to_normal_kernel.launches,
            "upsample": _upsample_kernel.upsample2x_bilinear_kernel.launches}
