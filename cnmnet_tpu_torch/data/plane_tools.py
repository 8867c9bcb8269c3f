"""Plane-annotation tooling (offline, numpy).

Counterparts of the substantive pieces of the reference's
`data_prepare/plane_utils.py` and `data_prepare/utils.py` grab-bag
(SURVEY.md §2.19-2.20):

* ``fit_plane`` — least-squares plane through points (`utils.py:615-620`);
* ``transform_planes`` — plane params between world/camera frames
  (`scannet_scene.py:121-138`);
* ``merge_coplanar_planes`` — unify segments whose normals differ < 5 deg
  and offsets agree (`plane_utils.py:245-348`);
* ``normals_from_depth_ransac`` is NOT re-vendored: the differentiable
  ``ops.normals.depth_to_normal`` supersedes `utils.py:474-551`;
* ``write_ply`` — point-cloud export (replaces the pyntcloud dependency,
  `plane_utils.py:73-200`);
* ``fit_transformation_ransac`` — Kabsch + RANSAC over correspondences
  (`utils.py:1088-1211`).

The port's copy of ``cnmnet_tpu/data/plane_tools.py``: numpy only, the same
functions with the same results (``tests/test_torch_plane_tools.py``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def fit_plane(points: np.ndarray) -> np.ndarray:
    """LSQ plane n with n . p = 1 for points [N, 3] (PlaneRCNN param
    convention: the plane is x . n = |n|^2 / |n| ... param = n / offset)."""
    return np.linalg.lstsq(points, np.ones(len(points)), rcond=None)[0]


def plane_params_to_normal_offset(param: np.ndarray) -> Tuple[np.ndarray, float]:
    """param = normal * offset -> (unit normal, offset)."""
    offset = float(np.linalg.norm(param))
    return param / max(offset, 1e-8), offset


def transform_planes(extrinsic: np.ndarray, planes: np.ndarray) -> np.ndarray:
    """Transform plane params (offset * normal, world) into the camera frame.

    A plane {p : n . p = d} maps under p' = R p + t to
    {p' : (R n) . p' = d + (R n) . t}.
    planes: [N, 3]; extrinsic: [4, 4] world->camera.
    """
    R = extrinsic[:3, :3]
    t = extrinsic[:3, 3]
    out = np.zeros_like(planes)
    for i, param in enumerate(planes):
        n, d = plane_params_to_normal_offset(param)
        n_c = R @ n
        d_c = d + n_c @ t
        out[i] = n_c * d_c
    return out


def merge_coplanar_planes(
    planes: np.ndarray,
    seg: np.ndarray,
    angle_threshold_deg: float = 5.0,
    offset_threshold: float = 0.1,
    non_planar_label: int = 20,
):
    """Merge near-coplanar plane instances into one label.

    Returns (merged_planes [M, 3], relabeled seg): labels are compacted;
    merged params are the area-weighted mean.
    """
    labels = [l for l in np.unique(seg) if l != non_planar_label and l < len(planes)]
    groups: List[List[int]] = []
    for l in labels:
        n_l, d_l = plane_params_to_normal_offset(planes[l])
        placed = False
        for g in groups:
            n_g, d_g = plane_params_to_normal_offset(planes[g[0]])
            cos = float(np.clip(np.dot(n_l, n_g), -1, 1))
            if np.degrees(np.arccos(abs(cos))) < angle_threshold_deg and (
                abs(d_l - d_g) < offset_threshold
            ):
                g.append(l)
                placed = True
                break
        if not placed:
            groups.append([l])

    new_seg = np.full_like(seg, non_planar_label)
    new_planes = []
    for new_label, g in enumerate(groups):
        areas = np.asarray([float((seg == l).sum()) for l in g])
        w = areas / max(areas.sum(), 1.0)
        new_planes.append(np.einsum("i,ij->j", w, planes[g]))
        for l in g:
            new_seg[seg == l] = new_label
    return (
        np.stack(new_planes) if new_planes else np.zeros((0, 3)),
        new_seg,
    )


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """Minimal binary-less PLY writer for point clouds [N, 3] (+ RGB u8)."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            line = f"{points[i, 0]:.5f} {points[i, 1]:.5f} {points[i, 2]:.5f}"
            if colors is not None:
                line += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(line + "\n")


def _kabsch(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rigid transform [4, 4] aligning src -> dst (centroid + SVD)."""
    cs, cd = src.mean(0), dst.mean(0)
    H = (src - cs).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = cd - R @ cs
    return T


def fit_transformation_ransac(
    src_points: np.ndarray,
    dst_points: np.ndarray,
    num_iterations: int = 100,
    inlier_threshold: float = 0.05,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """RANSAC rigid alignment over point correspondences [N, 3] x 2.

    Returns (T [4, 4], inlier mask).
    """
    n = len(src_points)
    rng = np.random.default_rng(seed)
    best_T = np.eye(4)
    best_inliers = np.zeros(n, bool)
    for _ in range(num_iterations):
        idx = rng.choice(n, size=min(3, n), replace=False)
        T = _kabsch(src_points[idx], dst_points[idx])
        moved = src_points @ T[:3, :3].T + T[:3, 3]
        inliers = np.linalg.norm(moved - dst_points, axis=1) < inlier_threshold
        if inliers.sum() > best_inliers.sum():
            best_inliers = inliers
            best_T = T
    if best_inliers.sum() >= 3:
        best_T = _kabsch(src_points[best_inliers], dst_points[best_inliers])
        moved = src_points @ best_T[:3, :3].T + best_T[:3, 3]
        best_inliers = np.linalg.norm(moved - dst_points, axis=1) < inlier_threshold
    return best_T, best_inliers
