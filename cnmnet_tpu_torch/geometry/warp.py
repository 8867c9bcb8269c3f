"""Backprojection, projection and bilinear warping (``cnmnet_tpu/geometry/warp.py``).

NHWC, f32, in pixel coordinates (no ``[-1, 1]`` grid round trip), with zero
padding outside the image. The sampler is the JAX module's gather form
(``bilinear_sample``): the four taps are gathered from the flattened image,
weighted and summed in the JAX order, and the gradient reaches the
coordinates through the fractions ``fx``, ``fy`` (``floor`` has none). The
dense hat-matrix form is a TPU device against slow gathers and is not
ported. The small camera products are broadcast sums (``camera._mm``), so
no TF32 setting on a card can round them.
"""

from __future__ import annotations

import torch

from cnmnet_tpu_torch.geometry.camera import _mm, pixel_grid


def bilinear_sample(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample ``image`` at float pixel coordinates with zero padding.

    Args:
      image: ``[B, H, W, C]``.
      x, y: ``[B, ...]`` column and row coordinates.

    Returns:
      ``[B, ..., C]``; taps outside the image contribute zero.
    """
    B, H, W, C = image.shape
    out_shape = tuple(x.shape) + (C,)
    x = x.reshape(B, -1)
    y = y.reshape(B, -1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = image.reshape(B, H * W, C)

    def tap(xi, yi, w):
        inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return vals * (w * inside.to(image.dtype))[..., None]

    out = (
        tap(x0i, y0i, (1.0 - fx) * (1.0 - fy))
        + tap(x0i + 1, y0i, fx * (1.0 - fy))
        + tap(x0i, y0i + 1, (1.0 - fx) * fy)
        + tap(x0i + 1, y0i + 1, fx * fy)
    )
    return out.reshape(out_shape)


def pixel2cam(depth: torch.Tensor, intrinsics_inv: torch.Tensor,
              row_offset: int = 0) -> torch.Tensor:
    """Camera-frame points ``K^-1 (u, v, 1)^T * d``.

    Args:
      depth: ``[B, H, W]``, the image's rows from global row ``row_offset``
        on (0: the whole image).
      intrinsics_inv: ``[B, 3, 3]`` (the full matrix is used).

    Returns:
      ``[B, H, W, 3]``.
    """
    _, h, w = depth.shape
    u, v, _ = pixel_grid(h, w, depth.dtype, depth.device, row_offset)
    k = intrinsics_inv[:, :, :, None, None]  # [B, 3, 3, 1, 1]
    rays = k[:, :, 0] * u + k[:, :, 1] * v + k[:, :, 2]  # [B, 3, H, W]
    return rays.permute(0, 2, 3, 1) * depth[..., None]


def cam2pixel(points: torch.Tensor, rotation: torch.Tensor, translation: torch.Tensor,
              z_clamp: float = 1e-3):
    """Project camera-frame points into another view's pixels.

    Args:
      points: ``[B, H, W, 3]`` in the reference camera frame.
      rotation: ``[B, 3, 3]``, the rotation block of ``K_src [R | t]``.
      translation: ``[B, 3]``, its translation block.
      z_clamp: the least projective depth divided by.

    Returns:
      (x, y, z), each ``[B, H, W]``: the source pixel coordinates and the
      unclamped projective depth in the source frame.
    """
    r = rotation[:, None, None]  # [B, 1, 1, 3, 3]
    proj = (r * points[..., None, :]).sum(-1) + translation[:, None, None, :]
    z = proj[..., 2]
    zc = torch.maximum(z, z.new_tensor(z_clamp))
    return proj[..., 0] / zc, proj[..., 1] / zc, z


def inverse_warp(feat: torch.Tensor, depth: torch.Tensor, pose: torch.Tensor,
                 intrinsics: torch.Tensor, intrinsics_inv: torch.Tensor, row_offset: int = 0):
    """Warp source-view features into the reference view given its depth.

    Args:
      feat: ``[B, Hs, W, C]`` source-view features (the whole image).
      depth: ``[B, H, W]`` reference-view depth, the image's rows from
        global row ``row_offset`` on (0: the whole image).
      pose: ``[B, 3, 4]`` ref->src rigid transform (rows of ``[R | t]``).
      intrinsics: ``[B, 3, 3]`` source K.
      intrinsics_inv: ``[B, 3, 3]`` inverse of the reference K.

    Returns:
      (warped ``[B, H, W, C]``, src_z ``[B, H, W]``): the source features
      resampled into the reference view (zero outside the source frame) and
      each reference point's depth in the source camera.
    """
    points = pixel2cam(depth, intrinsics_inv, row_offset)
    P = _mm(intrinsics, pose)  # [B, 3, 4]
    x, y, z = cam2pixel(points, P[:, :, :3], P[:, :, 3])
    return bilinear_sample(feat, x, y), z
