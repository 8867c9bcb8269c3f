"""Plane-segmentation evaluation metrics, a copy of ``cnmnet_tpu/ops/plane_metrics.py``.

Parity with the plane half of the reference's `utils/metric.py`:

* ``eval_iou`` — Jaccard index of two binary masks (`utils/metric.py:5-24`);
* ``eval_plane_prediction`` — per-plane depth-error recall curves at 0.05 m
  steps over IoU-matched plane pairs (`:28-68`);
* ``evaluate_depths`` — the PlaneNet-style depth metric pack with a plane
  mask (`:72-92`);
* ``eval_plane_and_pixel_recall_normal`` — plane/pixel recall as a function
  of normal-angle thresholds for IoU>0.5 matches (`:95-146`).

Host-side numpy (these run on eval outputs, not in the train step).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def eval_iou(annotation: np.ndarray, segmentation: np.ndarray) -> float:
    a = annotation.astype(bool)
    s = segmentation.astype(bool)
    if np.isclose(a.sum(), 0) and np.isclose(s.sum(), 0):
        return 1.0
    return float((a & s).sum() / (a | s).sum())


def eval_plane_prediction(
    pred_seg: np.ndarray,
    gt_seg: np.ndarray,
    pred_depth: np.ndarray,
    gt_depth: np.ndarray,
    threshold: float = 0.5,
    stride: float = 0.05,
    max_diff: float = 0.61,
):
    """Per-plane depth recall curves.

    pred_seg/gt_seg: label maps [H, W] (non-plane pixels outside 0..n-1) or
    one-hot stacks [H, W, N]. Returns (pixel_recalls, plane_statistics):
    pixel_recalls[k] = fraction of GT plane pixels whose matched plane's mean
    depth error <= k * stride; plane_statistics[k] = (num GT planes with an
    IoU>threshold match under the error bound, gt_plane_num, pred_plane_num).
    """
    pred_num = len(np.unique(pred_seg)) - 1 if pred_seg.ndim == 2 else pred_seg.shape[-1]
    gt_num = len(np.unique(gt_seg)) - 1 if gt_seg.ndim == 2 else gt_seg.shape[-1]

    if gt_seg.ndim == 2:
        gt_seg = (gt_seg[..., None] == np.arange(gt_num)).astype(np.float32)
    if pred_seg.ndim == 2:
        pred_seg = (pred_seg[..., None] == np.arange(pred_num)).astype(np.float32)

    plane_areas = gt_seg.sum(axis=(0, 1))  # [G]
    inter_mask = (gt_seg[..., :, None] * pred_seg[..., None, :]) > 0.5  # [H,W,G,P]

    depth_diffs = (gt_depth - pred_depth)[:, :, None, None]
    intersection = inter_mask.astype(np.float32).sum(axis=(0, 1))  # [G, P]
    plane_diffs = np.abs(depth_diffs * inter_mask).sum(axis=(0, 1)) / np.maximum(
        intersection, 1e-4
    )
    plane_diffs[intersection < 1e-4] = 1.0

    union = (
        (gt_seg[..., :, None] + pred_seg[..., None, :]) > 0.5
    ).astype(np.float32).sum(axis=(0, 1))
    plane_ious = intersection / np.maximum(union, 1e-4)

    num_predictions = int(pred_seg.max(axis=(0, 1)).sum())
    num_pixels = plane_areas.sum()

    iou_mask = (plane_ious > threshold).astype(np.float32)
    min_diff = np.min(plane_diffs * iou_mask + 1e6 * (1 - iou_mask), axis=1)

    pixel_recalls, plane_statistics = [], []
    for step in range(int(max_diff / stride + 1)):
        diff = step * stride
        pixel_recalls.append(
            float(
                np.minimum(
                    (intersection * (plane_diffs <= diff) * iou_mask).sum(1),
                    plane_areas,
                ).sum()
                / max(num_pixels, 1e-4)
            )
        )
        plane_statistics.append(
            (int((min_diff <= diff).sum()), gt_num, num_predictions)
        )
    return pixel_recalls, plane_statistics


def evaluate_depths(
    pred_depths: np.ndarray,
    gt_depths: np.ndarray,
    valid_masks: np.ndarray,
    plane_masks=True,
) -> Tuple[float, ...]:
    """PlaneNet depth metric pack over plane-masked pixels
    (rel, rel_sqr, log10, rmse, rmse_log, a1, a2, a3, recall)."""
    masks = np.logical_and(np.logical_and(valid_masks, plane_masks), gt_depths > 1e-4)
    n = float(max(masks.sum(), 1))
    rmse = np.sqrt((np.square(pred_depths - gt_depths) * masks).sum() / n)
    rmse_log = np.sqrt(
        (np.square(np.log(np.maximum(pred_depths, 1e-4)) - np.log(np.maximum(gt_depths, 1e-4))) * masks).sum() / n
    )
    log10 = (
        np.abs(np.log10(np.maximum(pred_depths, 1e-4)) - np.log10(np.maximum(gt_depths, 1e-4))) * masks
    ).sum() / n
    rel = (np.abs(pred_depths - gt_depths) / np.maximum(gt_depths, 1e-4) * masks).sum() / n
    rel_sqr = (
        np.square(pred_depths - gt_depths) / np.maximum(gt_depths, 1e-4) * masks
    ).sum() / n
    deltas = np.maximum(
        pred_depths / np.maximum(gt_depths, 1e-4),
        gt_depths / np.maximum(pred_depths, 1e-4),
    ) + (1 - masks.astype(np.float32)) * 10000
    a1 = (deltas < 1.25).sum() / n
    a2 = (deltas < 1.25**2).sum() / n
    a3 = (deltas < 1.25**3).sum() / n
    recall = float(masks.sum()) / max(float(np.asarray(valid_masks).sum()), 1.0)
    return rel, rel_sqr, log10, rmse, rmse_log, a1, a2, a3, recall


def eval_plane_and_pixel_recall_normal(
    segmentation: np.ndarray,
    gt_segmentation: np.ndarray,
    param: np.ndarray,
    gt_param: np.ndarray,
    threshold: float = 0.5,
    non_planar_label: int = 20,
):
    """Plane/pixel recall vs normal-angle thresholds (0..30 deg, 13 steps)
    for IoU-matched plane pairs."""
    angle_thresholds = np.linspace(0.0, 30.0, 13)
    plane_num = len([l for l in np.unique(segmentation) if l != non_planar_label])
    gt_plane_num = len(
        [l for l in np.unique(gt_segmentation) if l != non_planar_label]
    )

    plane_recall = np.zeros((max(gt_plane_num, 1), len(angle_thresholds)))
    pixel_recall = np.zeros((max(gt_plane_num, 1), len(angle_thresholds)))
    plane_area = 0.0
    gt_param = np.asarray(gt_param).reshape(-1, 3)

    for i in range(gt_plane_num):
        gt_plane = gt_segmentation == i
        plane_area += float(gt_plane.sum())
        for j in range(plane_num):
            pred_plane = segmentation == j
            if eval_iou(gt_plane, pred_plane) > threshold:
                n_gt = gt_param[i] / max(np.linalg.norm(gt_param[i]), 1e-8)
                n_pred = param[j] / max(np.linalg.norm(param[j]), 1e-8)
                deg = np.degrees(
                    np.arccos(np.clip(np.dot(n_gt, n_pred), -1.0, 1.0))
                )
                plane_recall[i] = (deg < angle_thresholds).astype(np.float32)
                pixel_recall[i] = (deg < angle_thresholds).astype(
                    np.float32
                ) * float((gt_plane & pred_plane).sum())
                break

    pixel_recall = pixel_recall.sum(0).reshape(1, -1) / max(plane_area, 1.0)
    return plane_recall, pixel_recall
