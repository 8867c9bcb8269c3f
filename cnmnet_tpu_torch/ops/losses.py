"""Training losses: masked, NaN-safe (``cnmnet_tpu/ops/losses.py``).

The same terms, masks and reductions as the JAX module, whose docstring
names the reference lines each one reproduces. Two rules hold throughout,
for the gradients as much as for the values:

* a masked-out entry may be inf or NaN, so masks select with
  ``torch.where`` before any arithmetic (``0 * inf`` is NaN, in a sum and
  in a backward alike), and norms carry an epsilon inside the square root;
* masked means divide by ``max(count, 1)``, so an empty mask gives 0, except
  where the reference's per-sample mean is NaN (``surface_normal_loss``),
  which is reproduced as a constant NaN branch.

``torch.maximum`` against a tensor stands wherever the JAX module takes
``jnp.maximum`` of a differentiable value: it splits the gradient at a tie
as ``jnp.maximum`` does (``clamp_min`` would not).

Every function takes ``group``: a mesh's group, or None for the batch in
hand. With a group each result is the value of the global batch, as the
JAX step's psums make it, the same on every rank:

* masked means (``masked_l1``, ``prob_weighted_l1``,
  ``prob_supervision_loss``, ``warped_depth_loss``) sum their terms over
  the group with a gradient (``parallel/collectives.group_sum``) and divide
  by the group's valid count, which carries none. A mean of the ranks'
  masked means would weigh each rank's valid pixels by the inverse of its
  own count;
* plain means (``multiscale_idepth_loss``, ``global_mean``) sum over the
  group and divide by the group's element count;
* ``surface_normal_loss`` averages the per-sample means over the group's
  samples, and is NaN when a sample of any rank has no valid pixel.

Under a tile axis the maps are this rank's rows and ``group`` is the whole
mesh's; ``spatial`` (``parallel/sharding.Spatial``) gives the rest:

* ``multiscale_idepth_loss`` keeps the ground-truth rows whose *global*
  index is a multiple of ``f`` (``Spatial.subsample``);
* ``surface_normal_loss`` sums each sample's terms and count over the tile
  group before it divides; the per-sample means are then the same on every
  tile rank, and the mean over the mesh weighs each sample ``tile`` times
  in its sum and its count alike;
* ``warped_depth_loss`` samples the source's ground truth at any row, so
  it gathers the whole source (no gradient), and projects its rows from
  their global pixel rows.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from cnmnet_tpu_torch.geometry.warp import inverse_warp
from cnmnet_tpu_torch.parallel.collectives import group_count, group_sum


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    total = torch.where(mask, x, 0.0).sum()
    count = mask.to(x.dtype).sum()
    if group is not None:
        total, count = group_sum(total, group), group_count(count, group)
    return total / torch.clamp_min(count, 1.0)


def global_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x.mean()``, over the group's elements when a group is given."""
    if group is None:
        return x.mean()
    return group_sum(x.sum(), group) / group_count(x.new_tensor(float(x.numel())), group)


def valid_pair_mask(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """gt > 0, both finite, pred > 0: the reference's L1 mask."""
    return (gt > 0.0) & torch.isfinite(gt) & torch.isfinite(pred) & (pred > 0.0)


def _log_diff(pred, gt, mask):
    return torch.abs(torch.log10(torch.where(mask, pred, 1.0))
                     - torch.log10(torch.where(mask, gt, 1.0)))


def masked_l1(pred: torch.Tensor, gt: torch.Tensor, log: bool = False,
              group=None) -> torch.Tensor:
    """Masked mean absolute error."""
    mask = valid_pair_mask(pred, gt)
    diff = _log_diff(pred, gt, mask) if log else torch.abs(pred - gt)
    return _masked_mean(diff, mask, group)


def multiscale_idepth_loss(preds: List[torch.Tensor], gt: torch.Tensor,
                           group=None, spatial=None) -> torch.Tensor:
    """0.1 x the mean of the unmasked L1 at scales 2-4.

    preds: [disp1, disp2, disp3, disp4], NHWC at (H, H/2, H/4, H/8); gt at
    full size, taken nearest (``gt[:, ::f, ::f]``; with ``spatial``, the
    rows whose global index is a multiple of ``f``).
    """
    def nearest(f):
        rows = gt[:, ::f] if spatial is None else spatial.subsample(gt, f, 1)
        return rows[:, :, ::f]

    losses = [global_mean(torch.abs(preds[i] - nearest(f)), group)
              for i, f in ((1, 2), (2, 4), (3, 8))]
    return 0.1 * sum(losses) / 3.0


def prob_weighted_l1(pred: torch.Tensor, gt: torch.Tensor, prob_map: torch.Tensor,
                     log: bool = False, group=None) -> torch.Tensor:
    """Mean of ``prob * |diff|`` over valid pixels."""
    mask = valid_pair_mask(pred, gt)
    diff = 10.0 * _log_diff(pred, gt, mask) if log else torch.abs(pred - gt)
    return _masked_mean(prob_map * diff, mask, group)


def prob_supervision_loss(prob_map: torch.Tensor, idepth_refined: torch.Tensor,
                          gt_idepth: torch.Tensor, prob_weight: float = 20.0, group=None):
    """(loss, prob_map_gt): ``prob_map`` against the pseudo ground truth
    ``exp(-prob_weight |idepth_refined - gt|)`` on valid pixels."""
    mask = valid_pair_mask(idepth_refined, gt_idepth)
    diff = torch.abs(idepth_refined - gt_idepth)
    prob_gt = torch.exp(-prob_weight * diff) * mask.to(prob_map.dtype)
    return _masked_mean(torch.abs(prob_map - prob_gt), mask, group), prob_gt


def surface_normal_loss(pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor,
                        probability_map: Optional[torch.Tensor] = None, eps: float = 1e-8,
                        group=None, spatial=None):
    """(loss, mean angle in degrees) of ``1 - cos`` between normal maps.

    Each sample's mean is over its own valid and finite pixels, and the
    per-sample means are averaged; a sample with no such pixel makes both
    results NaN (the reference's empty mean), through a constant branch
    whose gradient is zero.

    Args:
      pred, gt: ``[B, H, W, 3]``.
      valid: ``[B, H, W]`` bool.
      probability_map: optional ``[B, H, W]`` weights.
    """
    finite = torch.isfinite(gt.sum(-1)) & torch.isfinite(pred.sum(-1))
    mask_b = valid & finite
    mask = mask_b.to(pred.dtype)

    finite_b = finite[..., None]
    pred = torch.where(finite_b, pred, 0.0)
    gt = torch.where(finite_b, gt, 0.0)

    dot = (pred * gt).sum(-1)
    pn = torch.sqrt((pred * pred).sum(-1) + eps * eps)
    gn = torch.sqrt((gt * gt).sum(-1) + eps * eps)
    pg = pn * gn
    cos = dot / torch.maximum(pg, pg.new_tensor(eps))

    def image_sum(x):  # per sample, over the whole image's rows
        x = x.sum((1, 2))
        return x if spatial is None else spatial.tile_sum(x)

    count = image_sum(mask)
    safe_count = torch.clamp_min(count, 1.0)
    if probability_map is None:
        per_sample = image_sum(torch.where(mask_b, 1.0 - cos, 0.0)) / safe_count
    else:
        w = probability_map * mask
        ws = image_sum(w)
        per_sample = (image_sum(torch.where(mask_b, (1.0 - cos) * w, 0.0))
                      / torch.maximum(ws, ws.new_tensor(eps)))
    empty = (count == 0).to(pred.dtype).sum()
    all_nonempty = (empty if group is None else group_count(empty, group)) == 0
    nan = torch.full((), math.nan, dtype=pred.dtype, device=pred.device)
    loss = torch.where(all_nonempty, global_mean(per_sample, group), nan)

    ang = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    ang_per_sample = image_sum(torch.where(mask_b, ang, 0.0)) / safe_count
    mean_angle = torch.where(all_nonempty, global_mean(ang_per_sample, group), nan)
    return loss, mean_angle / math.pi * 180.0


def warped_depth_loss(depth_refined: torch.Tensor, gt_depth_src: torch.Tensor,
                      pose: torch.Tensor, intrinsics: torch.Tensor,
                      intrinsics_inv: torch.Tensor, max_depth: float = 10.0,
                      group=None, spatial=None) -> torch.Tensor:
    """Cross-view warped-depth consistency: the refined reference depth,
    moved into the source frame by ``pose`` (ref->src ``[B, 3, 4]``),
    against the source's GT depth sampled there; L1 over in-range,
    in-frustum points in front of both cameras."""
    row_offset = 0
    if spatial is not None:
        with torch.no_grad():
            gt_depth_src = spatial.gather(gt_depth_src, 0, dim=1)
        row_offset = spatial.rows(0)[0]
    warped_gt, src_z = inverse_warp(gt_depth_src[..., None], depth_refined, pose,
                                    intrinsics, intrinsics_inv, row_offset)
    warped_gt = warped_gt[..., 0]
    mask = ((warped_gt > 0.0) & (warped_gt < max_depth) & (src_z > 0.0)
            & (depth_refined > 0.0) & (depth_refined < max_depth)
            & torch.isfinite(src_z) & torch.isfinite(warped_gt))
    return _masked_mean(torch.abs(src_z - warped_gt), mask, group)
