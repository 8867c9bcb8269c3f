"""The training recipes' loss (``cnmnet_tpu/train/losses.py``).

``compute_losses`` is the full 12-term CNM recipe (disparity L1 at four
scales, depth L1, the refined terms, surface normals against the Combined
Normal Map, the probability terms and two cross-view warped-depth terms,
with the reference's NaN guard that drops the normal terms when they are
not finite) and the ``train_wo_normal`` recipe with its disparity-only
curriculum. Branches on values are arithmetic (``torch.where`` on scalars),
as in the JAX function, so no step waits on the device to choose one.

The depth->normal calls go through ``kernels/dispatch``: the CUDA kernel
(with its autograd Function) for CUDA tensors, the plain version for CPU
tensors or with ``backend="torch"``.

Under a mesh (``group``, the whole mesh's group) every term is the global
batch's value on every rank, as in the JAX step over the global batch:
the masked and plain means, ``prob_map.mean()`` and the normal terms are
reduced over the group as ``ops/losses.py`` says, so the NaN guard and the
logged metrics see the global values. The depth->normal and CNM-target
computations are per sample: local on a data mesh; under a tile axis
(``spatial``, this rank's rows of the batch's maps) depth->normal fetches
its halo rows (``parallel/tiled_ops.depth_to_normal_tiled``, with a
gradient), and the CNM target's plane means and the normal terms'
per-sample means sum over the tile group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from cnmnet_tpu_torch.geometry.camera import _mm, invert_intrinsics, invert_se3
from cnmnet_tpu_torch.kernels import dispatch
from cnmnet_tpu_torch.models.cnm import CNMOutputs
from cnmnet_tpu_torch.ops.losses import (
    global_mean,
    masked_l1,
    multiscale_idepth_loss,
    prob_supervision_loss,
    prob_weighted_l1,
    surface_normal_loss,
    warped_depth_loss,
)
from cnmnet_tpu_torch.ops.planes import normal_by_planes
from cnmnet_tpu_torch.parallel.tiled_ops import depth_to_normal_tiled

# Inverse-depth -> depth floor: at initialisation the sigmoid heads
# underflow at some pixels, and 1/idepth there makes depth terms of ~1e7
# whose gradients overflow. 0.01 (100 m) lies below the working range
# [0.02, 3.0] m^-1.
_IDEPTH_FLOOR = 1e-2


def _to_depth(idepth: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.maximum(idepth, idepth.new_tensor(_IDEPTH_FLOOR))


def _at(x: torch.Tensor, i: int) -> torch.Tensor:
    """``x[:, i]`` with the index clamped to the last entry, as a JAX index
    past the end is: with two views (one pair) both pair terms read pair 0
    and both warped terms read source view 1."""
    return x[:, min(i, x.shape[1] - 1)]


@dataclass(frozen=True)
class LossWeights:
    use_normal_loss: bool = True  # False -> the train_wo_normal recipe
    use_normal_refined_by_planes: bool = True  # CNM target vs raw GT normals
    curriculum_epochs: int = 5  # train_wo_normal: disparity-only warm-up
    prob_weight: float = 20.0
    include_prob_map_loss: bool = False
    k_size: int = 9
    backend: Optional[str] = None  # depth->normal backend (kernels/dispatch)


def compute_losses(out: CNMOutputs, batch: Dict[str, torch.Tensor], epoch: int,
                   w: LossWeights, group=None,
                   spatial=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics). ``batch`` holds tensors (NHWC): images
    [B,V,H,W,3], cams [B,V,2,4,4], depths [B,V,H,W], disparity [B,H,W],
    normals [B,H,W,3], instance_segs [B,S,H,W], planes_num [B]. The loss is
    in the graph; the metrics are its terms as detached scalars. ``group``:
    the group of a mesh (the terms are then the global batch's); ``spatial``:
    this rank's rows under a tile axis (the maps of ``out`` and ``batch``
    are those rows)."""
    g, sp = group, spatial
    gt_disp = batch["disparity"][..., None]
    gt_depth_ref = batch["depths"][:, 0][..., None]

    idepth01 = _at(out.disps[0], 0)  # [B, H, W, 1]
    idepth02 = _at(out.disps[0], 1)
    has_refiner = out.idepth_refined is not None

    loss_idepth_1 = 0.5 * (masked_l1(idepth01, gt_disp, group=g)
                           + masked_l1(idepth02, gt_disp, group=g))
    loss_idepth_234 = 0.5 * (
        multiscale_idepth_loss([_at(d, 0) for d in out.disps], gt_disp, g, sp)
        + multiscale_idepth_loss([_at(d, 1) for d in out.disps], gt_disp, g, sp)
    )
    depth01 = _to_depth(idepth01)
    depth02 = _to_depth(idepth02)
    loss_depth_1 = 0.5 * (masked_l1(depth01, gt_depth_ref, group=g)
                          + masked_l1(depth02, gt_depth_ref, group=g))
    metrics = {
        "loss_idepth": loss_idepth_1,
        "loss_idepth_234": loss_idepth_234,
        "loss_depth": loss_depth_1,
    }

    if has_refiner:
        idepth_refined = out.idepth_refined
        prob_map = out.prob_map
        depth_refined = _to_depth(idepth_refined)
        loss_idepth_refined = masked_l1(idepth_refined, gt_disp, group=g)
        loss_depth_refined = masked_l1(depth_refined, gt_depth_ref, group=g)
        prob_loss_depth = (prob_weighted_l1(idepth_refined, gt_disp, prob_map, group=g)
                           + prob_weighted_l1(depth_refined, gt_depth_ref, prob_map, group=g))
        prob_loss_minusmean = 1.0 - global_mean(prob_map, g)
        prob_map_loss, _ = prob_supervision_loss(prob_map, idepth_refined, gt_disp,
                                                 w.prob_weight, group=g)
        prob_loss = 5.0 * prob_loss_depth + prob_loss_minusmean
        if w.include_prob_map_loss:
            prob_loss = prob_loss + prob_map_loss
        metrics.update({
            "loss_idepth_refined": loss_idepth_refined,
            "loss_depth_refined": loss_depth_refined,
            "prob_loss": prob_loss,
            "prob_loss_depth": prob_loss_depth,
            "prob_loss_minusmean": prob_loss_minusmean,
            "prob_map_loss": prob_map_loss,
        })
    else:
        # DepthNet-only staged pretraining: no refined or probability terms.
        zero = torch.zeros_like(loss_idepth_1)
        idepth_refined = idepth01
        depth_refined = depth01
        loss_idepth_refined = zero
        loss_depth_refined = zero
        prob_loss = zero

    if not w.use_normal_loss:
        # train_wo_normal: disparity only for the first curriculum epochs,
        # then the depth and probability terms as well.
        primary = loss_idepth_1 + loss_idepth_234 + loss_idepth_refined
        secondary = loss_depth_1 + loss_depth_refined + prob_loss
        gate = float(epoch >= w.curriculum_epochs)
        loss_train = primary + gate * secondary
        metrics["loss"] = loss_train
        return loss_train, _detached(metrics)

    K = batch["cams"][:, 0, 1, 0:3, 0:3]
    K_inv = invert_intrinsics(K)

    def normals(depth):
        if sp is not None:
            return depth_to_normal_tiled(depth[..., 0], K_inv, sp, w.k_size, w.backend)
        return dispatch.depth_to_normal(depth[..., 0], K_inv, w.k_size, backend=w.backend)[0]

    n01, n02, n_ref = normals(depth01), normals(depth02), normals(depth_refined)

    gt_normal = batch["normals"]
    if w.use_normal_refined_by_planes:
        target_normal = normal_by_planes(gt_normal, batch["instance_segs"], batch["planes_num"],
                                         spatial=sp)
    else:
        target_normal = gt_normal
    valid = batch["depths"][:, 0] > 0.1

    ln01, ang01 = surface_normal_loss(n01, target_normal, valid, group=g, spatial=sp)
    ln02, ang02 = surface_normal_loss(n02, target_normal, valid, group=g, spatial=sp)
    ln_ref, ang_ref = surface_normal_loss(n_ref, target_normal, valid, group=g, spatial=sp)
    loss_normal_depth = 0.5 * (ln01 + ln02)
    loss_normal_depth_refined = ln_ref
    mean_angle = (ang01 + ang02 + ang_ref) / 3.0

    ref_E_inv = invert_se3(batch["cams"][:, 0, 0])
    warped = []
    for v in (1, 2):
        pose = _mm(_at(batch["cams"], v)[:, 0], ref_E_inv)[:, :3]  # ref -> src v
        warped.append(warped_depth_loss(depth_refined[..., 0], _at(batch["depths"], v), pose,
                                        K, K_inv, group=g, spatial=sp))
    warped_1, warped_2 = warped

    base = loss_idepth_1 + loss_depth_1 + loss_depth_refined + loss_idepth_refined
    normal_terms = loss_normal_depth + loss_normal_depth_refined + prob_loss
    normals_ok = torch.isfinite(loss_normal_depth) & torch.isfinite(loss_normal_depth_refined)
    loss_train = base + torch.where(normals_ok, normal_terms, 0.0)
    loss_train = loss_train + warped_1 + warped_2

    metrics.update({
        "loss": loss_train,
        "loss_normal_depth": loss_normal_depth,
        "loss_normal_depth_refined": loss_normal_depth_refined,
        "mean_normal_angle_deg": mean_angle,
        "warped_depth_loss_1": warped_1,
        "warped_depth_loss_2": warped_2,
    })
    return loss_train, _detached(metrics)


def _detached(metrics):
    return {k: v.detach() for k, v in metrics.items()}
