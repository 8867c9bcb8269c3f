"""Camera file IO: the reference's cameras/<id>_cam.txt format.

A copy of ``cnmnet_tpu/data/cameras.py`` (numpy only).

Format (written by `scannet/make_cameras.py:16-120`, parsed by
`scannet/preprocess.py:29-46`):

    extrinsic
    <4 rows of 4 floats>          # world -> camera
    (blank)
    intrinsic
    <3 rows of 3 floats>
    [<depth_min> <depth_interval>]  # optional trailing pair

``load_cam_text`` tokenizes positionally like the reference (words[1..16] =
extrinsic, words[18..26] = K) so files with or without the trailing pair or
exact whitespace parse identically.
"""

from __future__ import annotations

import numpy as np


def load_cam_text(text: str) -> np.ndarray:
    """Parse camera text -> the packed [2, 4, 4] array (float32)."""
    words = text.split()
    cam = np.zeros((2, 4, 4), np.float32)
    for i in range(4):
        for j in range(4):
            cam[0, i, j] = float(words[4 * i + j + 1])
    for i in range(3):
        for j in range(3):
            cam[1, i, j] = float(words[3 * i + j + 18])
    return cam


def write_cam_text(extrinsic: np.ndarray, K: np.ndarray,
                   depth_min: float | None = None,
                   depth_interval: float | None = None) -> str:
    lines = ["extrinsic"]
    for i in range(4):
        lines.append(" ".join(str(float(v)) for v in extrinsic[i]))
    lines.append("")
    lines.append("intrinsic")
    for i in range(3):
        lines.append(" ".join(str(float(v)) for v in K[i]))
    if depth_min is not None:
        lines.append("")
        lines.append(f"{depth_min} {depth_interval}")
    return "\n".join(lines) + "\n"


def make_cam_array(extrinsic: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Pack (4x4 extrinsic, 3x3 K) into the [2, 4, 4] camera array."""
    cam = np.zeros((2, 4, 4), np.float32)
    cam[0] = extrinsic
    cam[1, :3, :3] = K
    return cam


def scale_cam_array(cam: np.ndarray, scale_x: float, scale_y: float) -> np.ndarray:
    """Rescale intrinsics for a resized image (`scannet/preprocess.py:76-87`)."""
    out = cam.copy()
    out[1, 0, 0] *= scale_x
    out[1, 1, 1] *= scale_y
    out[1, 0, 2] *= scale_x
    out[1, 1, 2] *= scale_y
    return out
