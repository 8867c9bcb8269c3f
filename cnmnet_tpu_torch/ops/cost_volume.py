"""Plane-sweep cost volume — the plain PyTorch version.

Counterpart of ``cnmnet_tpu/ops/cost_volume.py`` and the plain version of
the CUDA kernel in ``kernels/cost_volume.py``: for each of ``P`` inverse
depths, warp every reference pixel into the source through
``K_s R K_r^-1 p + K_s t * idepth``, sample the source bilinearly with
zero padding, and record ``sum_c |warped - ref|``.

The volume is computed plane-major, ``[B, P, H, W]`` (what the stem
convolution reads), and returned as the ``[B, H, W, P]`` view of it that
the JAX package's contract names. No gradient flows through it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cnmnet_tpu_torch.geometry.camera import Camera, plane_sweep_terms


@functools.lru_cache(maxsize=32)
def idepth_hypotheses(idepth_scale: float, num_planes: int = 64, device=None) -> torch.Tensor:
    """The reference's inverse-depth grid: ``idepth_scale=3`` -> uniform in
    ``[0.1, 3.0]``, ``2`` -> ``[0.02, 2.0]``, otherwise ``[0.1 s / 3, s]``.

    Cached per (scale, planes, device), so a forward on a card does not wait
    on a host->device copy of the table; callers must not modify it."""
    if idepth_scale == 2.0:
        lo, hi = 0.02, 2.0
    elif idepth_scale == 3.0:
        lo, hi = 0.1, 3.0
    else:
        lo, hi = 0.1 * idepth_scale / 3.0, idepth_scale
    # jnp.linspace's f32 formula: start * (1 - step) + stop * step, exact stop
    lo, hi = np.float32(lo), np.float32(hi)
    div = max(num_planes - 1, 1)
    step = np.arange(num_planes, dtype=np.float32) / np.float32(div)
    grid = (lo * (np.float32(1.0) - step) + hi * step).astype(np.float32)
    if num_planes > 1:
        grid[-1] = hi
    return torch.from_numpy(grid).to(device)


def _sweep_coords(KRKiUV, KT, idepths, height, width, eps=1e-6):
    """Source pixel coordinates for every plane: x, y each ``[B, P, H*W]``.

    ``KRKiUV`` ``[B, 3, HW]``, ``KT`` ``[B, 3, 1]``, ``idepths`` ``[P]``.
    """
    hom = KRKiUV[:, None] + KT[:, None] * idepths[None, :, None, None]  # [B, P, 3, HW]
    denom = hom[:, :, 2] + eps
    # The z = -eps crossing would give 0/0; the clip keeps the int32 floor
    # defined. Both regimes lie outside the frustum and sample zero.
    denom = torch.where(denom.abs() < eps, torch.full_like(denom, eps), denom)
    bound = 100.0 * max(height, width)
    x = (hom[:, :, 0] / denom).clamp(-bound, bound)
    y = (hom[:, :, 1] / denom).clamp(-bound, bound)
    return x, y


def plane_sweep_cost_volume(ref_image, src_image, KRKiUV, KT, idepths) -> torch.Tensor:
    """Batched cost volume ``[B, P, H, W]`` (f32).

    ``ref_image``, ``src_image``: ``[B, H, W, C]``; ``KRKiUV`` ``[B, 3, H*W]``;
    ``KT`` ``[B, 3, 1]``; ``idepths`` ``[P]``. Out-of-frustum taps are zero,
    so their cost is ``sum |ref|``.
    """
    B, H, W, C = ref_image.shape
    P = idepths.shape[0]
    x, y = _sweep_coords(KRKiUV, KT, idepths, H, W)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = src_image.reshape(B, H * W, C)

    def tap(xi, yi, w):
        inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)  # [B, P, HW]
        vals = torch.gather(flat, 1, idx.reshape(B, P * H * W, 1).expand(-1, -1, C))
        return vals.reshape(B, P, H * W, C) * (w * inside)[..., None]

    warped = (
        tap(x0i, y0i, (1.0 - fx) * (1.0 - fy))
        + tap(x0i + 1, y0i, fx * (1.0 - fy))
        + tap(x0i, y0i + 1, (1.0 - fx) * fy)
        + tap(x0i + 1, y0i + 1, fx * fy)
    )
    diff = (warped - ref_image.reshape(B, 1, H * W, C)).abs()
    cost = diff[..., 0]
    for c in range(1, C):  # channels summed first to last, as the kernel sums them
        cost = cost + diff[..., c]
    return cost.reshape(B, P, H, W)


def cost_volume_from_cameras(
    ref_image: torch.Tensor,
    src_image: torch.Tensor,
    ref_cam: Camera,
    src_cam: Camera,
    idepth_scale: float = 3.0,
    num_planes: int = 64,
) -> torch.Tensor:
    """``[B, H, W, C]`` images and cameras of batch ``[B]`` -> ``[B, H, W, P]``
    (a view of the plane-major ``[B, P, H, W]`` result), detached."""
    with torch.no_grad():
        _, H, W, _ = ref_image.shape
        idepths = idepth_hypotheses(idepth_scale, num_planes, ref_image.device)
        KRKiUV, KT = plane_sweep_terms(ref_cam, src_cam, H, W)
        vol = plane_sweep_cost_volume(ref_image.float(), src_image.float(), KRKiUV, KT, idepths)
    return vol.permute(0, 2, 3, 1)
