"""Offline dataset preparation tools.

Counterparts of the reference's L0 pipeline (SURVEY.md §2.17-2.19):

* ``make_camera_files`` — `scannet/make_cameras.py:16-120`: per-frame
  ScanNet ``pose/*.txt`` (camera->world) + ``intrinsic/intrinsic_color.txt``
  -> ``cameras/<id>_cam.txt`` in the packed text format, intrinsics rescaled
  to the target resolution;
* ``make_train_list`` — `scannet/make_list.py:19-215`: walk scenes, emit
  ``(scene_id, frame_id)`` lines for frames whose whole view window passes
  validity checks (files exist, pose finite, depth non-empty, plane
  annotations present when required), frame ids strided;
* ``clean_plane_segmentation`` — the depth-consistency filter at the core of
  `data_prepare/utils.py:632-683` (``cleanSegmentation``): per plane
  instance, keep only pixels whose measured depth agrees with the plane's
  analytic depth, then drop small instances.

All plain numpy host code; no torch, no joblib (a thread pool fans out).

The port's copy of ``cnmnet_tpu/data/prep.py``. It imports no cv2: the PNGs
that the validity gates read (plane labels, depth) are decoded by
``data/imageio.read_png``, where the JAX module reads them with
``cv2.imread(path, -1)`` when cv2 is installed and skips those two gates
when it is not. A PNG that cannot be decoded rejects the frame.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from cnmnet_tpu_torch.data.cameras import write_cam_text
from cnmnet_tpu_torch.data.imageio import read_png


def read_png_or_none(path: str) -> Optional[np.ndarray]:
    """``cv2.imread(path, -1)``: the decoded PNG, or None where it cannot
    be read."""
    try:
        return read_png(path)
    except (OSError, ValueError, zlib.error):
        return None


def make_camera_files(
    scene_dir: str,
    out_width: int = 256,
    out_height: int = 192,
    depth_min: float = 300.0,
    depth_interval: float = 35.0,
    source_width: Optional[int] = None,
    source_height: Optional[int] = None,
) -> int:
    """Convert a ScanNet scene's poses+intrinsics to cameras/*_cam.txt."""
    pose_dir = os.path.join(scene_dir, "pose")
    K_path = os.path.join(scene_dir, "intrinsic", "intrinsic_color.txt")
    out_dir = os.path.join(scene_dir, "cameras")
    os.makedirs(out_dir, exist_ok=True)

    K4 = np.loadtxt(K_path)
    K = K4[:3, :3].copy()
    if source_width is None:
        # ScanNet color streams are 1296x968 (or 640x480 exports); infer from cx
        source_width = int(round(K[0, 2] * 2))
        source_height = int(round(K[1, 2] * 2))
    sx = out_width / source_width
    sy = out_height / source_height
    K[0, 0] *= sx
    K[0, 2] *= sx
    K[1, 1] *= sy
    K[1, 2] *= sy

    count = 0
    for name in sorted(os.listdir(pose_dir)):
        if not name.endswith(".txt"):
            continue
        frame_id = os.path.splitext(name)[0]
        pose = np.loadtxt(os.path.join(pose_dir, name))
        if not np.all(np.isfinite(pose)):
            continue
        extrinsic = np.linalg.inv(pose)  # camera->world -> world->camera
        text = write_cam_text(extrinsic, K, depth_min, depth_interval)
        with open(os.path.join(out_dir, f"{frame_id}_cam.txt"), "w") as f:
            f.write(text)
        count += 1
    return count


def _frame_valid(
    root: str,
    scene: str,
    frame_id: int,
    require_planes: bool,
    error_threshold: Optional[float] = None,
    check_normals: bool = False,
) -> bool:
    """One frame's validity under the reference's annotation-quality gates.

    Mirrors ``is_valid`` (`scannet/make_list.py:38-122`): readable rgb + cam
    with finite pose, and — behind flags — the plane-fit-error threshold
    (``planercnn_error_003/<id>.npy`` dict's ``error`` field), NaN-free
    ``normal/<id>.mat`` (nx/ny/nz), at least one plane label in the seg png,
    and nonempty plane params. Any unreadable gated file rejects the frame,
    exactly as the reference's bare try/excepts do.
    """
    sdir = os.path.join(root, scene)
    rgb = os.path.join(sdir, "rgb", f"{frame_id}.jpg")
    cam = os.path.join(sdir, "cameras", f"{frame_id}_cam.txt")
    if not (os.path.exists(rgb) and os.path.exists(cam)):
        return False
    try:
        with open(cam) as f:
            vals = [float(w) for w in f.read().split() if _is_float(w)]
        if not np.all(np.isfinite(vals)):
            return False
    except (ValueError, OSError):
        return False
    if error_threshold is not None:
        err_path = os.path.join(sdir, "planercnn_error_003", f"{frame_id}.npy")
        try:
            error = np.load(err_path, allow_pickle=True)[()]["error"]
        except Exception:
            return False
        if not np.isfinite(error) or error > error_threshold:
            return False
    if check_normals:
        mat_path = os.path.join(sdir, "normal", f"{frame_id}.mat")
        try:
            import scipy.io

            normal = scipy.io.loadmat(mat_path)
            for key in ("nx", "ny", "nz"):
                if np.any(np.isnan(normal[key])):
                    return False
        except Exception:
            return False
    if require_planes:
        seg = os.path.join(sdir, "planercnn_seg_003", f"{frame_id}.png")
        para = os.path.join(sdir, "planercnn_para_003", f"{frame_id}.npy")
        if not (os.path.exists(seg) and os.path.exists(para)):
            return False
        seg_img = read_png_or_none(seg)
        # `make_list.py:108-112`: a single unique label = no planes
        if seg_img is None or len(np.unique(seg_img)) == 1:
            return False
        try:
            if len(np.load(para)) == 0:
                return False
        except Exception:
            return False
    return True


def _is_float(w: str) -> bool:
    try:
        float(w)
        return True
    except ValueError:
        return False


def _ref_valid(root: str, scene: str, frame_id: int) -> bool:
    sdir = os.path.join(root, scene)
    depth = os.path.join(sdir, "depth", f"{frame_id}.png")
    if not os.path.exists(depth):
        return False
    d = read_png_or_none(depth)
    if d is None or not (d.max() > 0):
        return False
    return True


def make_train_list(
    root_dir: str,
    out_path: str,
    interval: int = 10,
    view_num: int = 3,
    frame_stride: int = 5,
    require_planes: bool = True,
    scenes: Optional[List[str]] = None,
    num_workers: int = 8,
    error_threshold: Optional[float] = None,
    check_normals: bool = False,
) -> int:
    """Emit (scene_id, frame_id) lines for frames with a valid view window.

    ``error_threshold`` / ``check_normals`` enable the reference's
    annotation-quality gates (`scannet/make_list.py:38-122`, default
    error_thred 0.7) on EVERY frame of the window, as the reference applies
    ``is_valid`` to the reference view and all source views alike
    (`make_list.py:148-167`). Plane presence (seg labels / nonempty params)
    is gated on the reference frame only — the training recipe consumes
    plane annotations for that frame alone (deviation from the reference,
    which requires them on source views it never reads).
    """
    if scenes is None:
        scenes = sorted(
            d for d in os.listdir(root_dir)
            if os.path.isdir(os.path.join(root_dir, d))
        )

    def scene_samples(scene: str) -> List[str]:
        rgb_dir = os.path.join(root_dir, scene, "rgb")
        if not os.path.isdir(rgb_dir):
            return []
        ids = sorted(
            int(os.path.splitext(f)[0])
            for f in os.listdir(rgb_dir)
            if f.endswith(".jpg") and os.path.splitext(f)[0].isdigit()
        )
        lines = []
        for fid in ids:
            if fid % frame_stride != 0:
                continue
            window = [fid + interval * (v - view_num // 2) for v in range(view_num)]
            if not all(
                _frame_valid(
                    root_dir, scene, w, require_planes and w == fid,
                    error_threshold=error_threshold,
                    check_normals=check_normals,
                )
                for w in window
            ):
                continue
            if not _ref_valid(root_dir, scene, fid):
                continue
            lines.append(f"{scene} {fid}")
        return lines

    with ThreadPoolExecutor(num_workers) as pool:
        all_lines = [l for lines in pool.map(scene_samples, scenes) for l in lines]

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(all_lines) + ("\n" if all_lines else ""))
    return len(all_lines)


def plane_depth_map(
    planes: np.ndarray, K_inv: np.ndarray, height: int, width: int
) -> np.ndarray:
    """Analytic per-plane depth maps [N, H, W] from plane params n*d (camera
    frame, ||n||=1/offset convention of PlaneRCNN: plane is n.p = |n|^2...
    here params are offset*normal, so n.p = d with n = params/|params|,
    d = |params|). Parity with `data_prepare/utils.py:439-470`."""
    uv = np.stack(
        [
            np.tile(np.arange(width, dtype=np.float64), (height, 1)),
            np.tile(np.arange(height, dtype=np.float64)[:, None], (1, width)),
            np.ones((height, width)),
        ]
    )
    rays = np.einsum("ij,jhw->ihw", K_inv, uv.reshape(3, -1).reshape(3, height, width))
    norms = np.linalg.norm(planes, axis=1, keepdims=True)  # [N, 1]
    n_unit = planes / np.maximum(norms, 1e-8)
    denom = np.einsum("ni,ihw->nhw", n_unit, rays)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = norms[:, :, None] / denom  # [N, 1->H, W]
    depth = t * rays[2][None]
    depth[~np.isfinite(depth)] = 0.0
    return depth


def clean_plane_segmentation(
    seg: np.ndarray,
    planes: np.ndarray,
    depth: np.ndarray,
    K_inv: np.ndarray,
    depth_tolerance: float = 0.1,
    min_area: int = 100,
    non_planar_label: int = 20,
) -> np.ndarray:
    """Depth-consistency cleaning of a plane label map.

    For each instance, keep only pixels where |analytic plane depth -
    measured depth| <= tolerance * depth; drop instances below min_area.
    Distills `cleanSegmentation` (`data_prepare/utils.py:632-683`) minus the
    cv2 morphology cosmetics.
    """
    H, W = seg.shape
    labels = [l for l in np.unique(seg) if l != non_planar_label and l < len(planes)]
    if not labels:
        return np.full_like(seg, non_planar_label)
    pd = plane_depth_map(planes[labels], K_inv, H, W)
    out = np.full_like(seg, non_planar_label)
    for k, label in enumerate(labels):
        mask = seg == label
        valid_d = depth > 1e-4
        ok = mask & valid_d & (
            np.abs(pd[k] - depth) <= depth_tolerance * np.maximum(depth, 1e-4)
        )
        # pixels without measured depth keep their label (can't refute them)
        ok |= mask & ~valid_d
        if ok.sum() >= min_area:
            out[ok] = label
    return out
