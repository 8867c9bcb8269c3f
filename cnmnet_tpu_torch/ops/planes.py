"""Plane-instance (CNM) ops (``cnmnet_tpu/ops/planes.py``).

Up to S = 20 plane-instance masks per image, ``[B, S, H, W]`` (slots past
``planes_num`` are ignored). The masks of one image are disjoint, so
replacing each instance's normals by the instance mean is one masked
composite: the Combined Normal Map.

The segment sums are broadcast multiplies summed by ``Tensor.sum``, never a
matmul or an einsum: the JAX package pins them to exact f32 with
``Precision.HIGHEST``, and no TF32 or reduced-precision matmul setting can
touch a plain reduction.

Under a tile axis the maps are this rank's rows, and ``spatial``
(``parallel/sharding.Spatial``) sums the segments of
``plane_average_normals`` over the tile group, so each instance's mean is
the whole image's.
"""

from __future__ import annotations

import torch


def _slot_mask(instance_segs: torch.Tensor, planes_num: torch.Tensor) -> torch.Tensor:
    """Zero out slots >= planes_num; ``[B, S, H, W]``."""
    S = instance_segs.shape[1]
    slots = torch.arange(S, device=instance_segs.device)[None, :]
    active = (slots < planes_num.to(slots.device)[:, None]).to(instance_segs.dtype)
    return instance_segs * active[:, :, None, None]


def _image_sum(x: torch.Tensor, spatial) -> torch.Tensor:
    """``x`` summed over dims 2 and 3 (the rows and columns), over the whole
    image's rows with ``spatial``."""
    x = x.sum((2, 3))
    return x if spatial is None else spatial.tile_sum(x)


def plane_average_normals(normals: torch.Tensor, instance_segs: torch.Tensor,
                          planes_num: torch.Tensor, eps: float = 1e-12, spatial=None):
    """Per-instance mean normals and the composited map.

    Args:
      normals: ``[B, H, W, 3]``.
      instance_segs: ``[B, S, H, W]`` binary, disjoint instance masks.
      planes_num: ``[B]`` int, live slots per image.

    Returns:
      (combined ``[B, H, W, 3]``, means ``[B, S, 3]``, masks ``[B, S, H, W]``):
      the Combined Normal Map (instance pixels replaced by their instance's
      mean, others untouched), the per-slot means and the gated masks.
    """
    m = _slot_mask(instance_segs.to(normals.dtype), planes_num)
    sums = _image_sum(m[..., None] * normals[:, None], spatial)  # [B, S, 3]
    counts = _image_sum(m, spatial)  # [B, S]
    means = sums / torch.maximum(counts, counts.new_tensor(eps))[..., None]
    inside = (m[..., None] * means[:, :, None, None, :]).sum(1)  # [B, H, W, 3]
    covered = torch.clamp(m.sum(1), 0.0, 1.0)[..., None]
    return inside + normals * (1.0 - covered), means, m


def normal_by_planes(gt_normal: torch.Tensor, instance_segs: torch.Tensor,
                     planes_num: torch.Tensor, spatial=None) -> torch.Tensor:
    """The Combined Normal Map, ``[B, H, W, 3]``."""
    combined, _, _ = plane_average_normals(gt_normal, instance_segs, planes_num,
                                           spatial=spatial)
    return combined


def plane_consistency_loss(normals: torch.Tensor, instance_segs: torch.Tensor,
                           planes_num: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Within-plane consistency, ``[B]``: per live instance the mean over its
    pixels of ``1 - cos(instance mean, normal)``, summed over instances (the
    JAX package's reading of the reference's plane branch; see its
    docstring for the deviation)."""
    _, means, m = plane_average_normals(normals, instance_segs, planes_num)

    def safe_unit(v):
        return v / torch.sqrt((v * v).sum(-1, keepdim=True) + eps)

    mean_unit = safe_unit(means)  # [B, S, 3]
    n_unit = safe_unit(normals)  # [B, H, W, 3]
    cos = (mean_unit[:, :, None, None, :] * n_unit[:, None]).sum(-1)  # [B, S, H, W]
    per_slot = (m * (1.0 - cos)).sum((2, 3)) / torch.clamp_min(m.sum((2, 3)), 1.0)
    return per_slot.sum(-1)
