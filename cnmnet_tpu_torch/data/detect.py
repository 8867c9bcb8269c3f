"""Detection-prep utilities: boxes, anchors, instance masks (offline, numpy).

Counterpart of the Mask-RCNN-style helper block in the reference's
`data_prepare/utils.py:21-293` (SURVEY.md §2.20) — box extraction/IoU/
refinement deltas, image/mask molding, and FPN anchor generation — used by
PlaneRCNN-lineage plane-annotation tooling. These are re-derived from the
published Faster-RCNN/FPN definitions and vectorized (no per-instance
Python loops); they are host-side prep code, deliberately pure numpy.

Conventions (identical to the reference so annotations interoperate):
  * boxes are ``[N, (y1, x1, y2, x2)]`` with an EXCLUSIVE bottom/right edge;
  * masks are ``[H, W, N]`` {0,1};
  * refinement deltas are ``(dy, dx, log(dh), log(dw))``.

The port's copy of ``cnmnet_tpu/data/detect.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """Tight boxes around instance masks (`utils.py:21-45` behavior).

    masks: [H, W, N] (any dtype; nonzero = inside). Returns int32 [N, 4]
    (y1, x1, y2, x2), exclusive ends; all-zero rows for empty masks.
    """
    m = np.asarray(masks) != 0
    h, w, n = m.shape
    any_col = m.any(axis=0)  # [W, N]
    any_row = m.any(axis=1)  # [H, N]
    nonempty = any_col.any(axis=0)  # [N]
    # argmax finds the first True; flipping finds the last.
    x1 = any_col.argmax(axis=0)
    x2 = w - any_col[::-1].argmax(axis=0)  # exclusive
    y1 = any_row.argmax(axis=0)
    y2 = h - any_row[::-1].argmax(axis=0)
    boxes = np.stack([y1, x1, y2, x2], axis=-1).astype(np.int32)
    boxes[~nonempty] = 0
    return boxes


def box_area(boxes: np.ndarray) -> np.ndarray:
    """Areas of [N, 4] (y1, x1, y2, x2) boxes."""
    b = np.asarray(boxes, dtype=np.float64)
    return np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)


def pairwise_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """IoU matrix [N1, N2] — covers both `compute_iou` and
    `compute_overlaps` (`utils.py:47-84`) in one vectorized call."""
    b1 = np.asarray(boxes1, dtype=np.float64)[:, None, :]  # [N1, 1, 4]
    b2 = np.asarray(boxes2, dtype=np.float64)[None, :, :]  # [1, N2, 4]
    inter_h = np.minimum(b1[..., 2], b2[..., 2]) - np.maximum(b1[..., 0], b2[..., 0])
    inter_w = np.minimum(b1[..., 3], b2[..., 3]) - np.maximum(b1[..., 1], b2[..., 1])
    inter = np.maximum(inter_h, 0) * np.maximum(inter_w, 0)
    union = box_area(boxes1)[:, None] + box_area(boxes2)[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def box_refinement(boxes: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    """Refinement deltas taking `boxes` to `gt_boxes`
    (`utils.py:86-110`): (dy, dx, log dh, log dw), center/size
    parameterization, vectorized over [N, 4]."""
    b = np.asarray(boxes, dtype=np.float64)
    g = np.asarray(gt_boxes, dtype=np.float64)
    bh, bw = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
    gh, gw = g[:, 2] - g[:, 0], g[:, 3] - g[:, 1]
    bcy, bcx = b[:, 0] + 0.5 * bh, b[:, 1] + 0.5 * bw
    gcy, gcx = g[:, 0] + 0.5 * gh, g[:, 1] + 0.5 * gw
    return np.stack(
        [(gcy - bcy) / bh, (gcx - bcx) / bw, np.log(gh / bh), np.log(gw / bw)],
        axis=-1,
    )


def apply_box_deltas(boxes: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """Inverse of :func:`box_refinement` (round-trip tested)."""
    b = np.asarray(boxes, dtype=np.float64)
    d = np.asarray(deltas, dtype=np.float64)
    h, w = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
    cy = b[:, 0] + 0.5 * h + d[:, 0] * h
    cx = b[:, 1] + 0.5 * w + d[:, 1] * w
    nh, nw = h * np.exp(d[:, 2]), w * np.exp(d[:, 3])
    return np.stack(
        [cy - 0.5 * nh, cx - 0.5 * nw, cy + 0.5 * nh, cx + 0.5 * nw], axis=-1
    )


def non_max_suppression(
    boxes: np.ndarray, scores: np.ndarray, threshold: float
) -> np.ndarray:
    """Greedy NMS; returns kept indices in score order."""
    order = np.argsort(np.asarray(scores))[::-1]
    keep: List[int] = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        iou = pairwise_iou(boxes[i : i + 1], boxes[rest])[0]
        order = rest[iou <= threshold]
    return np.array(keep, dtype=np.int64)


# ---------------------------------------------------------------------------
# image / mask molding
# ---------------------------------------------------------------------------


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Minimal half-pixel-centered bilinear resize, [H, W(,C)] float out."""
    img = np.asarray(img, dtype=np.float64)
    h, w = img.shape[:2]
    ys = (np.arange(out_h) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    if img.ndim == 3:
        wy, wx = wy[..., None], wx[..., None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def resize_image(
    image: np.ndarray,
    min_dim: int | None = None,
    max_dim: int | None = None,
    padding: bool = False,
) -> Tuple[np.ndarray, Tuple[int, int, int, int], float, List[Tuple[int, int]]]:
    """Scale so the short side reaches ``min_dim`` without the long side
    exceeding ``max_dim``; optionally zero-pad height to ``min_dim`` and
    width to ``max_dim`` — the reference's molded-image shape for
    non-square sensors, e.g. 480x640 (`utils.py:113-161`). Returns
    (image, window=(y1, x1, y2, x2) of the valid region, scale, pad_spec).
    """
    image = np.asarray(image)
    h, w = image.shape[:2]
    scale = 1.0
    if min_dim:
        scale = max(1.0, min_dim / min(h, w))
    if max_dim:
        if round(max(h, w) * scale) > max_dim:
            scale = max_dim / max(h, w)
    if scale != 1.0:
        image = _resize_bilinear(image, round(h * scale), round(w * scale))
    window = (0, 0, image.shape[0], image.shape[1])
    pad: List[Tuple[int, int]] = [(0, 0)] * image.ndim
    if padding:
        assert min_dim is not None and max_dim is not None
        top = (min_dim - image.shape[0]) // 2
        left = (max_dim - image.shape[1]) // 2
        pad[0] = (top, min_dim - image.shape[0] - top)
        pad[1] = (left, max_dim - image.shape[1] - left)
        image = np.pad(image, pad, mode="constant")
        window = (top, left, top + round(h * scale), left + round(w * scale))
    return image, window, scale, pad


def resize_mask(
    mask: np.ndarray, scale: float, pad: Sequence[Tuple[int, int]]
) -> np.ndarray:
    """Nearest-neighbor rescale of [H, W, N] masks by the image's scale,
    then the image's padding (`utils.py:163-175`)."""
    mask = np.asarray(mask)
    h, w = mask.shape[:2]
    oh, ow = round(h * scale), round(w * scale)
    ys = np.minimum((np.arange(oh) / scale).astype(np.int64), h - 1)
    xs = np.minimum((np.arange(ow) / scale).astype(np.int64), w - 1)
    out = mask[ys][:, xs]
    pad = list(pad)[: out.ndim]
    return np.pad(out, pad + [(0, 0)] * (out.ndim - len(pad)), mode="constant")


def minimize_mask(
    boxes: np.ndarray, masks: np.ndarray, mini_shape: Tuple[int, int]
) -> np.ndarray:
    """Crop each instance mask to its box and resize to ``mini_shape``
    (bool out; `utils.py:177-192`). Empty boxes produce empty minis."""
    boxes = np.asarray(boxes)
    masks = np.asarray(masks) != 0
    out = np.zeros(mini_shape + (masks.shape[-1],), dtype=bool)
    for i in range(masks.shape[-1]):
        y1, x1, y2, x2 = boxes[i].astype(np.int64)
        if y2 <= y1 or x2 <= x1:
            continue
        crop = masks[y1:y2, x1:x2, i].astype(np.float64)
        out[:, :, i] = _resize_bilinear(crop, *mini_shape) >= 0.5
    return out


def minimize_depth(
    boxes: np.ndarray, depth: np.ndarray, mini_shape: Tuple[int, int]
) -> np.ndarray:
    """Per-instance box crops of a shared depth map, resized to
    ``mini_shape`` with NEAREST-neighbor sampling (`utils.py:194-207`,
    cv2.INTER_NEAREST there) — bilinear would average across depth
    discontinuities at instance boundaries and synthesize depths that lie
    on no real surface."""
    boxes = np.asarray(boxes)
    depth = np.asarray(depth, dtype=np.float64)
    mh, mw = mini_shape
    out = np.zeros(mini_shape + (len(boxes),), dtype=np.float64)
    for i, (y1, x1, y2, x2) in enumerate(boxes.astype(np.int64)):
        if y2 <= y1 or x2 <= x1:
            continue
        crop = depth[y1:y2, x1:x2]
        h, w = crop.shape
        ys = np.minimum((np.arange(mh) * (h / mh)).astype(np.int64), h - 1)
        xs = np.minimum((np.arange(mw) * (w / mw)).astype(np.int64), w - 1)
        out[:, :, i] = crop[ys][:, xs]
    return out


def expand_mask(
    box: np.ndarray, mini_mask: np.ndarray, image_shape: Tuple[int, int]
) -> np.ndarray:
    """Paste one mini mask back into a full-size boolean mask
    (`unmold_mask`, `utils.py:213-233`)."""
    y1, x1, y2, x2 = np.asarray(box).astype(np.int64)
    full = np.zeros(image_shape[:2], dtype=bool)
    if y2 > y1 and x2 > x1:
        full[y1:y2, x1:x2] = (
            _resize_bilinear(np.asarray(mini_mask, dtype=np.float64), y2 - y1, x2 - x1)
            >= 0.5
        )
    return full


def mold_image(images: np.ndarray, mean_pixel: Sequence[float]) -> np.ndarray:
    """Subtract the dataset mean pixel (`utils.py:346-352`)."""
    return np.asarray(images, dtype=np.float32) - np.asarray(
        mean_pixel, dtype=np.float32
    )


def unmold_image(normalized: np.ndarray, mean_pixel: Sequence[float]) -> np.ndarray:
    """Inverse of :func:`mold_image`, back to uint8 (`utils.py:354-358`;
    rounded rather than truncated so the float32 round trip is exact)."""
    return np.rint(np.asarray(normalized) + np.asarray(mean_pixel)).astype(np.uint8)


def compose_image_meta(
    image_id: int,
    image_shape: Sequence[int],
    window: Sequence[int],
    active_class_ids: Sequence[int],
) -> np.ndarray:
    """Pack per-image metadata into one flat vector (`utils.py:300-320`)."""
    return np.concatenate(
        [
            np.asarray([image_id], dtype=np.float64),
            np.asarray(image_shape, dtype=np.float64),
            np.asarray(window, dtype=np.float64),
            np.asarray(active_class_ids, dtype=np.float64),
        ]
    )


def parse_image_meta(meta: np.ndarray) -> Dict[str, np.ndarray]:
    """Unpack :func:`compose_image_meta` (batched; `utils.py:322-344`)."""
    meta = np.atleast_2d(np.asarray(meta))
    return {
        "image_id": meta[:, 0],
        "image_shape": meta[:, 1:4],
        "window": meta[:, 4:8],
        "active_class_ids": meta[:, 8:],
    }


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------


def generate_anchors(
    scales: Sequence[float] | float,
    ratios: Sequence[float],
    feature_shape: Tuple[int, int],
    feature_stride: int,
    anchor_stride: int = 1,
) -> np.ndarray:
    """Dense anchor grid for one pyramid level (`utils.py:236-273`).

    Returns [H'*W'*len(scales)*len(ratios), 4] (y1, x1, y2, x2) boxes in
    image coordinates, centered on feature cells, fully vectorized.
    """
    scales_a, ratios_a = np.meshgrid(
        np.atleast_1d(np.asarray(scales, dtype=np.float64)),
        np.asarray(ratios, dtype=np.float64),
    )
    scales_a, ratios_a = scales_a.ravel(), ratios_a.ravel()
    heights = scales_a / np.sqrt(ratios_a)
    widths = scales_a * np.sqrt(ratios_a)
    ys = np.arange(0, feature_shape[0], anchor_stride, dtype=np.float64)
    xs = np.arange(0, feature_shape[1], anchor_stride, dtype=np.float64)
    cy, cx = np.meshgrid(ys * feature_stride, xs * feature_stride, indexing="ij")
    cy = cy.ravel()[:, None]  # [cells, 1]
    cx = cx.ravel()[:, None]
    boxes = np.stack(
        [
            np.broadcast_to(cy - 0.5 * heights, (len(cy), len(heights))),
            np.broadcast_to(cx - 0.5 * widths, (len(cx), len(widths))),
            np.broadcast_to(cy + 0.5 * heights, (len(cy), len(heights))),
            np.broadcast_to(cx + 0.5 * widths, (len(cx), len(widths))),
        ],
        axis=-1,
    )
    return boxes.reshape(-1, 4)


def generate_pyramid_anchors(
    scales: Sequence[float],
    ratios: Sequence[float],
    feature_shapes: Sequence[Tuple[int, int]],
    feature_strides: Sequence[int],
    anchor_stride: int = 1,
) -> np.ndarray:
    """One scale per FPN level, concatenated level-major
    (`utils.py:275-297`)."""
    return np.concatenate(
        [
            generate_anchors(s, ratios, shape, stride, anchor_stride)
            for s, shape, stride in zip(scales, feature_shapes, feature_strides)
        ],
        axis=0,
    )
