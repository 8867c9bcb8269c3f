"""Camera algebra as plain functions on a small named tuple of tensors.

Counterpart of ``cnmnet_tpu/geometry/camera.py``; same conventions:

* ``extrinsic`` is the 4x4 world->camera transform ``E``;
* ``intrinsic`` is the 3x3 pinhole matrix ``K``;
* a packed camera array is ``[..., 2, 4, 4]`` with ``cam[..., 0]`` the
  extrinsic and ``cam[..., 1, :3, :3]`` the intrinsic;
* pixel grids are row-major ``[H, W]``, ``u`` = column, ``v`` = row.

Everything is float32 and exact: the small products are written as
broadcast multiplies and sums (``_mm``), never ``torch.matmul``, so no
TF32 setting on a CUDA device can round the camera terms to ten bits
(a 2^-10 error in ``K R K^-1`` moves the warp by whole sub-pixels).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    """A batch of pinhole cameras: extrinsic ``[..., 4, 4]``, intrinsic
    ``[..., 3, 3]``."""

    extrinsic: torch.Tensor
    intrinsic: torch.Tensor

    @property
    def batch_shape(self):
        return self.extrinsic.shape[:-2]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact f32 ``a @ b`` for small matrices (no TF32, no BLAS)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def camera_from_array(cam: torch.Tensor) -> Camera:
    """Unpack the ``[..., 2, 4, 4]`` camera array."""
    return Camera(extrinsic=cam[..., 0, :, :], intrinsic=cam[..., 1, :3, :3])


def invert_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of ``[[fx, s, cx], [0, fy, cy], [0, 0, 1]]``."""
    fx = K[..., 0, 0]
    s = K[..., 0, 1]
    cx = K[..., 0, 2]
    fy = K[..., 1, 1]
    cy = K[..., 1, 2]
    one = torch.ones_like(fx)
    zero = torch.zeros_like(fx)
    row0 = torch.stack([one / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)], -1)
    row1 = torch.stack([zero, one / fy, -cy / fy], -1)
    row2 = torch.stack([zero, zero, one], -1)
    return torch.stack([row0, row1, row2], -2)


def invert_se3(E: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid 4x4 transform: ``[R^T, -R^T t]``."""
    Rt = E[..., :3, :3].transpose(-1, -2)
    t = E[..., :3, 3:4]
    top = torch.cat([Rt, -_mm(Rt, t)], -1)
    bottom = torch.zeros_like(top[..., :1, :])  # made on the device: no host copy
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], -2)


def relative_pose(ref: Camera, src: Camera) -> torch.Tensor:
    """``E_src @ E_ref^-1``: ref-camera coordinates -> src-camera coordinates."""
    return _mm(src.extrinsic, invert_se3(ref.extrinsic))


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel coordinates ``[3, H, W]``: (u, v, 1) per pixel."""
    v = torch.arange(height, dtype=dtype, device=device)[:, None].expand(height, width)
    u = torch.arange(width, dtype=dtype, device=device)[None, :].expand(height, width)
    return torch.stack([u, v, torch.ones_like(u)], 0)


def plane_sweep_homography(ref: Camera, src: Camera):
    """The two per-pair plane-sweep terms: ``K_s R K_r^-1`` ``[..., 3, 3]``
    and ``K_s t`` ``[..., 3, 1]`` for the ref->src pose ``[R | t]``."""
    rel = relative_pose(ref, src)
    R = rel[..., :3, :3]
    t = rel[..., :3, 3:4]
    KRKi = _mm(_mm(src.intrinsic, R), invert_intrinsics(ref.intrinsic))
    KT = _mm(src.intrinsic, t)
    return KRKi, KT


def plane_sweep_terms(ref: Camera, src: Camera, height: int, width: int):
    """Per-pixel homography terms: ``KRKiUV`` ``[..., 3, H*W]`` (``K_s R
    K_r^-1 (u, v, 1)`` for every pixel) and ``KT`` ``[..., 3, 1]``.

    ``KRKiUV`` is evaluated as ``(k0 * u + k1 * v) + k2`` per row, each step
    rounded to f32: the cost-volume kernel repeats exactly these roundings,
    so both produce the same sampling coordinates.
    """
    KRKi, KT = plane_sweep_homography(ref, src)
    uv = pixel_grid(height, width, KRKi.dtype, KRKi.device).reshape(3, height * width)
    k = KRKi[..., None]  # [..., 3, 3, 1]
    KRKiUV = k[..., 0, :] * uv[0] + k[..., 1, :] * uv[1] + k[..., 2, :]
    return KRKiUV, KT
