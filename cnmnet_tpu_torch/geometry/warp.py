"""Backprojection (``cnmnet_tpu/geometry/warp.py:pixel2cam``).

The rest of the JAX module (bilinear sampling, ``cam2pixel``,
``inverse_warp``) serves the training losses and comes with the training
slice.
"""

from __future__ import annotations

import torch

from cnmnet_tpu_torch.geometry.camera import pixel_grid


def pixel2cam(depth: torch.Tensor, intrinsics_inv: torch.Tensor) -> torch.Tensor:
    """Camera-frame points ``K^-1 (u, v, 1)^T * d``.

    Args:
      depth: ``[B, H, W]``.
      intrinsics_inv: ``[B, 3, 3]`` (the full matrix is used).

    Returns:
      ``[B, H, W, 3]``.
    """
    _, h, w = depth.shape
    u, v, _ = pixel_grid(h, w, depth.dtype, depth.device)
    k = intrinsics_inv[:, :, :, None, None]  # [B, 3, 3, 1, 1]
    rays = k[:, :, 0] * u + k[:, :, 1] * v + k[:, :, 2]  # [B, 3, H, W]
    return rays.permute(0, 2, 3, 1) * depth[..., None]
