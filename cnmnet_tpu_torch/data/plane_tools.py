"""Plane-annotation tooling (``cnmnet_tpu/data/plane_tools.py``).

Only ``fit_plane``, which the ScanNet plane eval uses, is ported; the rest
of the JAX module is offline tooling (ROADMAP, slice 6).
"""

from __future__ import annotations

import numpy as np


def fit_plane(points: np.ndarray) -> np.ndarray:
    """LSQ plane n with n . p = 1 for points [N, 3] (PlaneRCNN param
    convention: the plane is x . n = |n|^2 / |n| ... param = n / offset)."""
    return np.linalg.lstsq(points, np.ones(len(points)), rcond=None)[0]
