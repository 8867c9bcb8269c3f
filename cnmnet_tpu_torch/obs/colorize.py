"""Visualization colorizers (pure numpy), a copy of ``cnmnet_tpu/obs/colorize.py``.

Counterparts of the reference's `depthnet/depth_util.py:59-137` colorizers
(rainbow depth/prob maps, normal->RGB) with a self-contained rainbow LUT
instead of ``cv2.applyColorMap``.
"""

from __future__ import annotations

import numpy as np


def _rainbow_lut() -> np.ndarray:
    """256-entry RGB rainbow (blue -> green -> red), float in [0, 1]."""
    t = np.linspace(0.0, 1.0, 256)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


_LUT = _rainbow_lut()


def _apply_lut(normalized: np.ndarray) -> np.ndarray:
    idx = np.clip(normalized * 255.0, 0, 255).astype(np.uint8)
    return (_LUT[idx] * 255).astype(np.uint8)


def colorize_depth(depth: np.ndarray, min_depth=0.3, max_depth=8.0) -> np.ndarray:
    d = np.where((depth < min_depth) | (depth > max_depth), 0.0, depth)
    return _apply_lut((d - min_depth) / (max_depth - min_depth))


def colorize_idepth(idepth: np.ndarray, scale: float = 8.0) -> np.ndarray:
    return _apply_lut((idepth - 0.1) / scale)


def colorize_prob(prob: np.ndarray) -> np.ndarray:
    return _apply_lut(np.clip(prob, 0.0, 1.0))


def normal_to_color(normal: np.ndarray) -> np.ndarray:
    """[-1, 1] normals -> uint8 RGB."""
    return ((normal / 2.0 + 0.5) * 255).astype(np.uint8)
