"""ScanNet test-set evaluation.

The reference evaluates ScanNet through the same networks with its
`test.txt` list (16 held-out samples; `configs/config.yaml:6` keeps a
`scannet_test_eva_dir` slot). Here: run the multi-view forward over a
ScanNet-format dataset (or any object yielding its sample dict) and
aggregate the nine depth metrics under the eval clamp ([0.3, 8.0] m,
`eval.py:1009-1037`).

A copy of ``cnmnet_tpu/evals/scannet_eval.py`` for the port: the forward
is any callable of numpy inputs returning tensors or arrays (build it with
``evals.seven_scenes_eval.make_eval_forward``); the metrics are numpy.

One deliberate difference: ``evaluate_scannet_planes`` hands
``eval_plane_prediction`` one-hot plane masks where the JAX function hands it
the label map. From a label map that function counts the planes as its
distinct values less one (the non-planar label), so on a sample where
every pixel lies on a kept plane the JAX function drops its last plane from
the depth-recall curve, and on a one-plane sample it raises. Where a
sample has non-planar pixels both give the same numbers bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from cnmnet_tpu_torch.data.plane_tools import fit_plane
from cnmnet_tpu_torch.ops import metrics as M
from cnmnet_tpu_torch.ops.plane_metrics import (
    eval_plane_and_pixel_recall_normal,
    eval_plane_prediction,
    evaluate_depths,
)


def _idepth(out) -> np.ndarray:
    """The idepth of a forward's output as numpy, from both the bare-idepth
    and the ``(idepth, prob, normal)`` contract of ``make_eval_forward``."""
    idepth = out[0] if isinstance(out, tuple) else out
    if hasattr(idepth, "cpu"):  # a tensor; the copy waits for the device
        idepth = idepth.cpu()
    return np.asarray(idepth)


def evaluate_scannet(
    forward_fn,
    dataset,
    max_samples: Optional[int] = None,
    min_depth: float = 0.3,
    max_depth: float = 8.0,
    logger=None,
) -> Dict[str, float]:
    """forward_fn: (images [1, V, h, w, 3], cams [1, V, 2, 4, 4]) -> idepth
    [1, h, w, 1]. dataset: indexable yielding the ScanNet sample dict."""
    per_frame: List[Dict[str, float]] = []
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for i in range(n):
        sample = dataset[i]
        images = np.asarray(sample["images"])[None]
        cams = np.asarray(sample["cams"])[None]
        pred_depth = 1.0 / (_idepth(forward_fn(images, cams))[0, :, :, 0] + 1e-8)
        gt_depth = np.asarray(sample["depths"][0])

        pred = np.clip(pred_depth, min_depth, max_depth)
        mask = M.compute_valid_depth_mask(
            gt_depth, min_thred=min_depth, max_thred=max_depth
        )
        if mask.sum() == 0:
            continue
        per_frame.append(M.compute_errors(pred[mask], gt_depth[mask]))
        if logger is not None and (i + 1) % 10 == 0:
            logger.log_scalars(i + 1, per_frame[-1], prefix="scannet_eval")

    if not per_frame:
        return {}
    keys = per_frame[0].keys()
    out = {k: float(np.mean([f[k] for f in per_frame])) for k in keys}
    out["frames"] = float(len(per_frame))
    return out


def _backproject(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """depth [H, W] + intrinsics -> camera-frame points [H, W, 3]."""
    H, W = depth.shape
    uv = np.stack(
        [
            np.tile(np.arange(W, dtype=np.float64), (H, 1)),
            np.repeat(np.arange(H, dtype=np.float64)[:, None], W, axis=1),
            np.ones((H, W)),
        ]
    )
    rays = np.einsum("ij,jhw->ihw", np.linalg.inv(K), uv)
    return (rays * depth[None]).transpose(1, 2, 0)


def evaluate_scannet_planes(
    forward_fn,
    dataset,
    max_samples: Optional[int] = None,
    min_points: int = 10,
    non_planar_label: int = 20,
) -> Dict[str, float]:
    """Per-plane geometric fidelity of the predicted depth on ScanNet.

    CNMNet predicts depth/normals, not plane detections, so the PlaneNet
    metric suite (`utils/metric.py:28-146`) is applied to the plane
    decomposition *induced* by the prediction: each GT plane instance's
    support carries a plane LSQ-fitted to the predicted 3-D points inside
    it, compared against the GT plane (dataset ``plane_paras`` when
    present, else a fit to the GT points). Reports:

    * ``plane_recall_normal_{5,10,30}deg`` / ``pixel_recall_normal_*`` —
      fraction of GT planes (pixels) whose induced plane's normal is within
      the angle threshold (`eval_plane_and_pixel_recall_normal`);
    * ``pixel_recall_depth_{10,60}cm`` — fraction of planar pixels whose
      plane's mean depth error is under the bound (`eval_plane_prediction`);
    * the PlaneNet depth pack over planar pixels (`evaluate_depths`):
      ``plane_rel``, ``plane_rmse``, ``plane_a1``.
    """
    plane_rows, pixel_rows = [], []
    depth_curves, depth_packs = [], []
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    used = 0
    for i in range(n):
        sample = dataset[i]
        S = int(sample.get("planes_num", 0))
        if S == 0:
            continue
        images = np.asarray(sample["images"])[None]
        cams = np.asarray(sample["cams"])[None]
        pred_depth = 1.0 / (_idepth(forward_fn(images, cams))[0, :, :, 0] + 1e-8)
        gt_depth = np.asarray(sample["depths"][0])
        K = np.asarray(sample["cams"][0, 1, :3, :3])
        inst = np.asarray(sample["instance_segs"])  # [20, H, W] one-hot

        pts_pred = _backproject(pred_depth, K)
        pts_gt = _backproject(gt_depth, K)
        gt_paras = sample.get("plane_paras")

        label = np.full(gt_depth.shape, non_planar_label, np.int32)
        params_pred, params_gt = [], []
        for k in range(S):
            mask = (inst[k] > 0) & (gt_depth > 1e-4)
            if mask.sum() < min_points:
                continue
            cid = len(params_pred)
            label[mask] = cid
            params_pred.append(fit_plane(pts_pred[mask]))
            if gt_paras is not None and np.linalg.norm(gt_paras[k]) > 1e-8:
                params_gt.append(np.asarray(gt_paras[k], np.float64))
            else:
                params_gt.append(fit_plane(pts_gt[mask]))
        if not params_pred:
            continue
        used += 1

        pr, px = eval_plane_and_pixel_recall_normal(
            label, label, np.asarray(params_pred), np.asarray(params_gt),
            non_planar_label=non_planar_label,
        )
        plane_rows.append(pr)
        pixel_rows.append(px[0])

        # one-hot planes: eval_plane_prediction counts the planes of a label
        # map as its distinct values less one, and misses one where no pixel
        # is non-planar
        planes = (label[..., None] == np.arange(len(params_pred))).astype(np.float32)
        recalls, _stats = eval_plane_prediction(planes, planes, pred_depth, gt_depth)
        depth_curves.append(recalls)
        depth_packs.append(
            evaluate_depths(
                pred_depth, gt_depth, gt_depth > 1e-4, label != non_planar_label
            )
        )

    if not used:
        return {}
    plane_curve = np.concatenate(plane_rows, axis=0).mean(axis=0)  # [13]
    pixel_curve = np.stack(pixel_rows).mean(axis=0)  # [13] over 0..30 deg
    depth_curve = np.stack(depth_curves).mean(axis=0)  # [13] over 0..0.6 m
    pack = np.stack(depth_packs).mean(axis=0)
    # angle grid: linspace(0, 30, 13) -> 2.5 deg steps; depth grid 0.05 m
    result = {
        "plane_recall_normal_5deg": float(plane_curve[2]),
        "plane_recall_normal_10deg": float(plane_curve[4]),
        "plane_recall_normal_30deg": float(plane_curve[12]),
        "pixel_recall_normal_5deg": float(pixel_curve[2]),
        "pixel_recall_normal_10deg": float(pixel_curve[4]),
        "pixel_recall_normal_30deg": float(pixel_curve[12]),
        "pixel_recall_depth_10cm": float(depth_curve[2]),
        "pixel_recall_depth_60cm": float(depth_curve[12]),
        "plane_rel": float(pack[0]),
        "plane_rmse": float(pack[3]),
        "plane_a1": float(pack[5]),
        "frames": float(used),
    }
    return result
