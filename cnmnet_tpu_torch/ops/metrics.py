"""Depth evaluation metrics (``cnmnet_tpu/ops/metrics.py``).

Numpy implementations with the same definitions as the reference's
`utils/metric.py:149-362` (masked arrays of valid depths in, scalars out),
copied from the JAX package so that both give the same float32 sums (numpy's
pairwise ``np.mean``), plus ``compute_all`` on tensors, which evaluates
every metric in one pass on the device.

The metric set (`eval.py:1038-1047`): l1, abs-rel, sq-rel, rmse, rmse-log,
scale-invariant, and the delta < 1.25^n ratio thresholds. The reference's
ratio_threshold compares |log d1 - log d2| < log(thr), which is the
symmetric max(d1/d2, d2/d1) < thr.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def compute_valid_depth_mask(d1, d2=None, min_thred=0.3, max_thred=8.0):
    """Valid = finite and inside (min, max); if d2 given, both must be."""
    if d2 is None:
        return (d1 < max_thred) & (d1 > min_thred) & np.isfinite(d1)
    return (
        (d1 < max_thred) & (d1 > min_thred) & np.isfinite(d1)
        & (d2 < max_thred) & (d2 > min_thred) & np.isfinite(d2)
    )


def l1(depth1, depth2):
    return float(np.mean(np.abs(depth1 - depth2))) if depth1.size else float("nan")


def l1_inverse(depth1, depth2):
    if not depth1.size:
        return float("nan")
    return float(np.mean(np.abs(np.reciprocal(depth1) - np.reciprocal(depth2))))


def rmse(depth1, depth2):
    if not depth1.size:
        return float("nan")
    return float(np.sqrt(np.mean(np.square(depth1 - depth2))))


def rmse_log(depth1, depth2):
    if not depth1.size:
        return float("nan")
    return float(np.sqrt(np.mean(np.square(np.log(depth1) - np.log(depth2)))))


def scale_invariant(depth1, depth2):
    if not depth1.size:
        return float("nan")
    log_diff = np.log(depth1) - np.log(depth2)
    # clamp: the variance form cancels catastrophically for constant ratios
    var = max(np.mean(np.square(log_diff)) - np.square(np.mean(log_diff)), 0.0)
    return float(np.sqrt(var))


def abs_relative(depth_pred, depth_gt):
    if not depth_pred.size:
        return float("nan")
    return float(np.mean(np.abs(depth_pred - depth_gt) / depth_gt))


def sq_relative(depth_pred, depth_gt):
    if not depth_pred.size:
        return float("nan")
    return float(np.mean(np.square(depth_pred - depth_gt) / depth_gt))


def avg_log10(depth1, depth2):
    if not depth1.size:
        return float("nan")
    return float(np.mean(np.abs(np.log10(depth1) - np.log10(depth2))))


def ratio_threshold(depth1, depth2, threshold):
    assert threshold > 0.0
    if not depth1.size:
        return float("nan")
    log_diff = np.abs(np.log(depth1) - np.log(depth2))
    return float(np.mean(log_diff < np.log(threshold)))


METRIC_NAMES = (
    "l1",
    "abs_rel",
    "sq_rel",
    "rmse",
    "rmse_log",
    "scale_inv",
    "a1",
    "a2",
    "a3",
)


def compute_errors(pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """All nine metrics on pre-masked 1-D arrays (pred/gt > 0, finite)."""
    return {
        "l1": l1(gt, pred),
        "abs_rel": abs_relative(pred, gt),
        "sq_rel": sq_relative(pred, gt),
        "rmse": rmse(gt, pred),
        "rmse_log": rmse_log(gt, pred),
        "scale_inv": scale_invariant(gt, pred),
        "a1": ratio_threshold(gt, pred, 1.25),
        "a2": ratio_threshold(gt, pred, 1.25**2),
        "a3": ratio_threshold(gt, pred, 1.25**3),
    }


def compute_depth_scale_factor(
    depth1: np.ndarray, depth2: np.ndarray, depth_scaling: str = "abs"
) -> float:
    """LSQ scale for depth1 minimizing error to depth2.

    Reference `utils/metric.py:407-445`; three alignment spaces:
    ``abs``  — minimize MSE on depth:      s = Σd1·d2 / Σd1²
    ``log``  — minimize MSE on log depth:  s = exp(mean(log d2 − log d1))
    ``inv``  — minimize MSE on 1/depth:    s = (Σ(1/d1)² ) / (Σ(1/d1)(1/d2))
    ``abs``/``inv`` sums run over the valid mask of the product term, as in
    the reference; inputs must be finite and positive (asserted there too).
    """
    depth1, depth2 = np.asarray(depth1), np.asarray(depth2)
    assert np.all(
        np.isfinite(depth1) & np.isfinite(depth2) & (depth1 > 0) & (depth2 > 0)
    ), "compute_depth_scale_factor expects finite positive depths"

    if depth_scaling == "abs":
        d1d1 = depth1 * depth1
        d1d2 = depth1 * depth2
        mask = compute_valid_depth_mask(d1d2)
        sum_d1d1 = float(np.sum(d1d1[mask]))
        return float(np.sum(d1d2[mask]) / sum_d1d1) if sum_d1d1 > 0 else 1.0
    if depth_scaling == "log":
        return float(np.exp(np.mean(np.log(depth2) - np.log(depth1))))
    if depth_scaling == "inv":
        i1, i2 = np.reciprocal(depth1), np.reciprocal(depth2)
        d1d1 = i1 * i1
        d1d2 = i1 * i2
        mask = compute_valid_depth_mask(d1d2)
        sum_d1d2 = float(np.sum(d1d2[mask]))
        if float(np.sum(d1d1[mask])) > 0 and sum_d1d2 != 0.0:
            return float(np.sum(d1d1[mask]) / sum_d1d2)
        return 1.0
    raise ValueError(f"unknown depth_scaling {depth_scaling!r}")


def evaluate_depth(
    translation_gt: np.ndarray,
    depth_gt: np.ndarray,
    depth_pred: np.ndarray,
    inverse_gt: bool = True,
    inverse_pred: bool = True,
    depth_scaling: str = "abs",
):
    """Errors without and with LSQ scale alignment of the prediction.

    Reference `utils/metric.py:448-497`: mask both maps jointly, optionally
    invert (the reference evaluates *inverse*-depth buffers by default), and
    if the GT translation is not unit-norm divide GT by its norm (pose-scale
    normalization for scale-ambiguous baselines). Returns
    ``(errors, errors_after_scaling)`` — each the 9-metric dict of
    :func:`compute_errors`.
    """
    translation_gt = np.asarray(translation_gt, np.float64)
    valid = compute_valid_depth_mask(depth_pred, depth_gt)
    pred = np.asarray(depth_pred)[valid]
    gt = np.asarray(depth_gt)[valid]
    if inverse_gt:
        gt = np.reciprocal(gt)
    if inverse_pred:
        pred = np.reciprocal(pred)

    t_norm = float(np.sqrt(translation_gt.dot(translation_gt)))
    if not np.isclose(1.0, t_norm):
        gt = gt / t_norm

    def _masked_errors(p, g):
        # the reference's compute_errors re-masks its inputs
        # (`utils/metric.py:378-381`), so out-of-range inverted or scaled
        # values drop out of each error computation independently
        m = compute_valid_depth_mask(p, g)
        return compute_errors(p[m], g[m])

    errs = _masked_errors(pred, gt)
    scale = compute_depth_scale_factor(pred, gt, depth_scaling=depth_scaling)
    errs_scaled = _masked_errors(pred * scale, gt)
    return errs, errs_scaled


def compute_all(
    pred: torch.Tensor,
    gt: torch.Tensor,
    min_depth: float = 0.3,
    max_depth: float = 8.0,
) -> Dict[str, torch.Tensor]:
    """On-device, mask-weighted version of every metric in one pass (the
    counterpart of the JAX package's ``compute_all_jnp``).

    pred is clamped to [min_depth, max_depth] (the eval protocol's clamp,
    `eval.py:1031-1032`); gt outside the range is masked out.
    """
    pred = torch.clamp(pred, min_depth, max_depth)
    mask = (gt > min_depth) & (gt < max_depth) & torch.isfinite(gt)
    m = mask.to(pred.dtype)
    n = torch.clamp(m.sum(), min=1.0)
    gt_safe = torch.where(mask, gt, torch.ones_like(gt))

    diff = pred - gt
    log_diff = torch.log(pred) - torch.log(gt_safe)
    abs_log = log_diff.abs()

    def mmean(x):
        return (x * m).sum() / n

    mean_log = mmean(log_diff)
    log125 = float(np.log(1.25))
    return {
        "l1": mmean(diff.abs()),
        "abs_rel": mmean(diff.abs() / gt_safe),
        "sq_rel": mmean(diff.square() / gt_safe),
        "rmse": torch.sqrt(mmean(diff.square())),
        "rmse_log": torch.sqrt(mmean(log_diff.square())),
        "scale_inv": torch.sqrt(torch.clamp(mmean(log_diff.square()) - mean_log.square(), min=0.0)),
        "a1": mmean((abs_log < log125).to(pred.dtype)),
        "a2": mmean((abs_log < 2 * log125).to(pred.dtype)),
        "a3": mmean((abs_log < 3 * log125).to(pred.dtype)),
        "valid_count": m.sum(),
    }
