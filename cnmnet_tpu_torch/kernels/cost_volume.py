"""Plane-sweep cost volume: the CUDA kernel's wrapper.

Replaces ``cnmnet_tpu/kernels/cost_volume_pallas.py:cost_volume_pallas``
with the hand-written kernel in ``csrc/cost_volume.cu`` (its header states
the bound on an H100 and the design). The plain version is
``ops/cost_volume.py``; ``cost_volume`` below takes it for CPU tensors only
and launches the kernel or raises for CUDA tensors.

``cost_volume_kernel.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from cnmnet_tpu_torch.geometry.camera import Camera, plane_sweep_homography
from cnmnet_tpu_torch.kernels import build
from cnmnet_tpu_torch.ops import cost_volume as plain

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def pack_coefs(ref_cam: Camera, src_cam: Camera) -> torch.Tensor:
    """Per-pair homography coefficients ``[B, 12]`` f32: ``K_s R K_r^-1``
    row-major, then ``K_s t`` (the ``_pack_coefs`` of the TPU kernel, minus
    its idepth ramp: the kernel reads the plane table itself)."""
    KRKi, KT = plane_sweep_homography(ref_cam, src_cam)
    B = KRKi.shape[0]
    return torch.cat([KRKi.reshape(B, 9), KT.reshape(B, 3)], 1).float().contiguous()


def cost_volume_kernel(
    ref_images: torch.Tensor,
    src_images: torch.Tensor,
    coefs: torch.Tensor,
    idepths: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Launch the kernel: ``[B, H, W, 3]`` f32 images, ``[B, 12]``
    coefficients and the ``[P]`` plane table, all contiguous on one CUDA
    device -> ``[B, P, H, W]`` in ``out_dtype`` (f32 or bf16; the cost
    accumulates in f32 either way). Does not synchronise."""
    if not ref_images.is_cuda:
        raise ValueError("cost_volume_kernel takes CUDA tensors")
    B, H, W, C = ref_images.shape
    P = idepths.shape[0]
    for name, t, shape in (
        ("ref_images", ref_images, (B, H, W, 3)),
        ("src_images", src_images, (B, H, W, 3)),
        ("coefs", coefs, (B, 12)),
        ("idepths", idepths, (P,)),
    ):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: want f32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != ref_images.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {ref_images.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    lib = build.load("cost_volume")
    fn = lib.cnm_cost_volume
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((B, P, H, W), dtype=out_dtype, device=ref_images.device)
    with torch.cuda.device(ref_images.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            ref_images.data_ptr(), src_images.data_ptr(), coefs.data_ptr(),
            idepths.data_ptr(), out.data_ptr(), B, H, W, P,
            int(out_dtype == torch.bfloat16), stream,
        )
    build.check(status, "cnm_cost_volume")
    cost_volume_kernel.launches += 1
    return out


cost_volume_kernel.launches = 0


def cost_volume(
    ref_images: torch.Tensor,
    src_images: torch.Tensor,
    ref_cam: Camera,
    src_cam: Camera,
    idepth_scale: float = 3.0,
    num_planes: int = 64,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Batched cost volume ``[B, H, W, P]``: a view of the plane-major
    ``[B, P, H, W]`` result. CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if not ref_images.is_cuda:
        vol = plain.cost_volume_from_cameras(
            ref_images, src_images, ref_cam, src_cam, idepth_scale, num_planes
        )
        return vol.to(out_dtype)
    with torch.no_grad():
        idepths = plain.idepth_hypotheses(idepth_scale, num_planes, ref_images.device)
        vol = cost_volume_kernel(
            ref_images.float().contiguous(), src_images.float().contiguous(),
            pack_coefs(ref_cam, src_cam), idepths, out_dtype,
        )
    return vol.permute(0, 2, 3, 1)
