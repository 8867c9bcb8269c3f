"""Standalone metric re-aggregation over a saved eval artifact directory
(``cnmnet_tpu/evals/cal_metrics.py``).

Parity with the reference's ``cal_metrics`` sacred command
(the reference's `eval.py:995-1090`): walk ``<data_dir>/<scene>/<seq*>``,
score every ``gt_depth/*.npy`` frame against ``pred_depth/*.npy``, resize
the prediction to the GT resolution (bilinear), clamp predictions to
[0.3, 8.0] m, mask GT to the same range, average the nine depth metrics
over frames, and write ``evaluation_errors.txt`` into ``data_dir`` with the
reference's exact line labels.

This is the cross-implementation comparison tool: it re-scores an existing
artifact directory — ours (``cli eval --save-dir``) or one produced by the
reference's eval commands (same layout: per-seq ``pred_depth``/``gt_depth``
dirs of ``*.{pred,gt}_depth.npy``).

GT source: by default the saved ``gt_depth/*.npy`` buffers (native 480x640
in our dumps). With ``gt_root`` set, GT is instead read from the original
dataset's ``<scene>/<seq>/<frame>.depth.png`` / 1000 — exactly what the
reference does (`eval.py:1024-1026`, it uses the artifact dir only for the
frame census). The two agree wherever the saved npy is the native-res GT:
the >8 m clamp masks the 65535 mm invalid marker either way.

The GT PNG is decoded and the prediction resized by ``data/imageio`` (cv2's
float ``INTER_LINEAR`` bit for bit on float32), not by cv2.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from cnmnet_tpu_torch.data.imageio import read_png, resize_linear_f32
from cnmnet_tpu_torch.ops import metrics as M

# the reference's output line labels, in print order (`eval.py:1070-1090`)
_REFERENCE_LABELS = {
    "l1": "mean_l1_error",
    "a1": "a<1.25",
    "a2": "a<1.25^2",
    "a3": "a<1.25^3",
    "abs_rel": "abs.rel",
    "sq_rel": "sq.rel",
    "rmse": "rmse",
    "rmse_log": "rmse log",
    "scale_inv": "scale.inv",
}


def frame_metrics(
    pred_depth: np.ndarray,
    gt_depth: np.ndarray,
    min_depth: float = 0.3,
    max_depth: float = 8.0,
) -> Dict[str, float]:
    """One frame, exact `cal_metrics` treatment (`eval.py:1029-1050`):
    resize pred to GT, clamp pred to [min, max], mask GT to (min, max)."""
    pred = np.clip(resize_linear_f32(pred_depth, *gt_depth.shape), min_depth, max_depth)
    mask = M.compute_valid_depth_mask(
        gt_depth, min_thred=min_depth, max_thred=max_depth
    )
    return M.compute_errors(pred[mask], gt_depth[mask])


def cal_metrics(
    data_dir: str,
    gt_root: Optional[str] = None,
    min_depth: float = 0.3,
    max_depth: float = 8.0,
    write_txt: bool = True,
) -> Dict[str, float]:
    """Re-aggregate metrics over a saved artifact tree.

    Returns the nine aggregate metrics plus ``frames``; writes
    ``<data_dir>/evaluation_errors.txt`` (reference parity) unless
    ``write_txt`` is False.
    """
    per_frame: List[Dict[str, float]] = []
    for scene in sorted(os.listdir(data_dir)):
        scene_dir = os.path.join(data_dir, scene)
        if not os.path.isdir(scene_dir):
            continue
        for seq in sorted(os.listdir(scene_dir)):
            if not seq.startswith("seq"):
                continue
            gt_dir = os.path.join(scene_dir, seq, "gt_depth")
            pred_dir = os.path.join(scene_dir, seq, "pred_depth")
            if not os.path.isdir(gt_dir) or not os.path.isdir(pred_dir):
                continue
            for filename in sorted(os.listdir(gt_dir)):
                if not filename.endswith(".npy"):
                    continue
                if gt_root is not None:
                    gt = read_png(
                        os.path.join(
                            gt_root,
                            scene,
                            seq,
                            filename.replace("gt_depth.npy", "depth.png"),
                        )
                    ).astype(np.float64) / 1000.0
                else:
                    gt = np.load(os.path.join(gt_dir, filename))
                pred = np.load(
                    os.path.join(
                        pred_dir, filename.replace("gt_depth", "pred_depth")
                    )
                )
                per_frame.append(
                    frame_metrics(pred, gt, min_depth=min_depth, max_depth=max_depth)
                )

    result = {
        k: float(np.mean([f[k] for f in per_frame])) if per_frame else float("nan")
        for k in _REFERENCE_LABELS
    }
    result["frames"] = float(len(per_frame))
    if write_txt:
        with open(os.path.join(data_dir, "evaluation_errors.txt"), "w") as f:
            for key, label in _REFERENCE_LABELS.items():
                f.write(f"{label}: {result[key]}\n")
    return result
