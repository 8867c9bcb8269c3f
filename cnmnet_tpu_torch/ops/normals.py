"""Depth -> surface normals by k x k least-squares plane fits — plain PyTorch.

Counterpart of ``cnmnet_tpu/ops/normals.py`` and the plain version of the
CUDA kernel in ``kernels/normals.py``: backproject depth to camera-frame
points, mask depths outside ``(valid_min, valid_max)``, take the nine
zero-padded k x k window sums of the monomials (xx, xy, xz, yy, yz, zz, x,
y, z), solve ``(A^T A) n = A^T 1`` by the closed-form adjugate (identity
where ``det < 1e-5`` or NaN), and L2-normalise.

The box sum is written as shifted slice additions of the zero-padded input,
vertical pass then horizontal, each tap added in order: exact f32 that no
TF32 setting touches. Every expression here is one elementwise op after
another, so each step rounds once, left to right; the kernel rounds at the
same steps in the same order and gives the same normals.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cnmnet_tpu_torch.geometry.warp import pixel2cam


def box_filter(x: torch.Tensor, k_size: int) -> torch.Tensor:
    """Separable k x k box sum with zero padding, ``[B, H, W, C]``."""
    _, H, W, _ = x.shape
    pad = k_size // 2
    xp = F.pad(x, (0, 0, 0, 0, pad, pad))  # rows
    y = xp[:, 0:H]
    for d in range(1, k_size):
        y = y + xp[:, d : d + H]
    yp = F.pad(y, (0, 0, pad, pad))  # columns
    out = yp[:, :, 0:W]
    for d in range(1, k_size):
        out = out + yp[:, :, d : d + W]
    return out


def solve_normal_equations(moments: torch.Tensor, det_eps: float = 1e-5) -> torch.Tensor:
    """Adjugate solve of ``(A^T A) n = A^T 1`` from ``[..., 9]`` moments
    (Sxx, Sxy, Sxz, Syy, Syz, Szz, Sx, Sy, Sz) -> ``[..., 3]`` unnormalised
    normals; singular systems (``det < det_eps`` or NaN) give ``A^T 1``."""
    a, b, c, d, e, f, rx, ry, rz = moments.unbind(-1)

    det = a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d)

    adj00 = d * f - e * e
    adj01 = c * e - b * f
    adj02 = b * e - c * d
    adj11 = a * f - c * c
    adj12 = b * c - a * e
    adj22 = a * d - b * b

    nx = adj00 * rx + adj01 * ry + adj02 * rz
    ny = adj01 * rx + adj11 * ry + adj12 * rz
    nz = adj02 * rx + adj12 * ry + adj22 * rz

    singular = torch.isnan(det) | (det < det_eps)
    inv_det = 1.0 / torch.where(singular, torch.ones_like(det), det)
    nx = torch.where(singular, rx, nx * inv_det)
    ny = torch.where(singular, ry, ny * inv_det)
    nz = torch.where(singular, rz, nz * inv_det)
    return torch.stack([nx, ny, nz], -1)


def depth_to_normal(
    depth: torch.Tensor,
    intrinsics_inv: torch.Tensor,
    k_size: int = 9,
    valid_min: float = 0.0,
    valid_max: float = 10.0,
    norm_eps: float = 1e-5,
):
    """``depth`` ``[B, H, W]``, ``intrinsics_inv`` ``[B, 3, 3]`` ->
    (unit normals ``[B, H, W, 3]``, points ``[B, H, W, 3]``)."""
    points = pixel2cam(depth, intrinsics_inv)
    valid = ((depth > valid_min) & (depth < valid_max)).to(depth.dtype)
    p = points * valid[..., None]
    x, y, z = p.unbind(-1)
    monomials = torch.stack([x * x, x * y, x * z, y * y, y * z, z * z, x, y, z], -1)
    n = solve_normal_equations(box_filter(monomials, k_size))
    # safe norm: keeps the gradient finite where n == 0; summed left to right
    nx, ny, nz = n.unbind(-1)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz + 1e-20)[..., None]
    return n / (norm + norm_eps), points
