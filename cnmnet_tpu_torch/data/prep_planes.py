"""Offline plane-annotation preparation.

Counterpart of the reference's `data_prepare/scannet_scene.py` pipeline
(SURVEY.md §2.19): starting from a ScanNet scene with PlaneRCNN-style global
annotations —

    <scene>/annotation/planes.npy        [N_global, 3] world-frame params
    <scene>/annotation/plane_info.npy    per-plane metadata (ids)
    <scene>/annotation/segmentation/<id>.png   RGB-packed global plane ids
    <scene>/{depth,pose,intrinsic}/...

— produce the per-frame training annotations the online loader reads:

    <scene>/planercnn_seg_003/<id>.png   per-frame compacted label map
    <scene>/planercnn_para_003/<id>.npy  per-frame camera-frame plane params

Per frame: decode the RGB-packed global ids, remap to per-frame labels,
transform plane params into the camera frame (`scannet_scene.py:121-138`),
clean the segmentation by depth consistency (`utils.py:632-683` distilled in
``prep.clean_plane_segmentation``), merge near-coplanar segments, and reject
frames whose mean plane-depth error exceeds 1 m (`scannet_scene.py:226-234`).

A thread pool fans out over frames (the reference used joblib processes).

The port's copy of ``cnmnet_tpu/data/prep_planes.py``, without cv2: PNGs are
read by ``data/imageio.read_png``, which returns the packed segmentation in
RGB order already (``cv2.imread`` gives BGR, which the JAX module swaps),
a depth map of another size is resized by ``imageio.resize_nearest`` (equal
to cv2's ``INTER_NEAREST``), and the label maps are written by
``imageio.write_png``: other bytes than cv2's, the same pixels.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from cnmnet_tpu_torch.data.imageio import resize_nearest, write_png
from cnmnet_tpu_torch.data.plane_tools import merge_coplanar_planes, transform_planes
from cnmnet_tpu_torch.data.prep import read_png_or_none, clean_plane_segmentation, plane_depth_map

NON_PLANAR = 20


def decode_packed_segmentation(seg_rgb: np.ndarray) -> np.ndarray:
    """RGB-packed global plane ids -> int map (id = r*256^2 + g*256 + b - 1;
    0 packs 'no plane'). Matches the PlaneRCNN annotation encoding."""
    packed = (
        seg_rgb[..., 0].astype(np.int64) * 256 * 256
        + seg_rgb[..., 1].astype(np.int64) * 256
        + seg_rgb[..., 2].astype(np.int64)
    )
    return packed - 1  # -1 = non-planar


def prepare_frame(
    scene_dir: str,
    frame_id: str,
    planes_world: np.ndarray,
    K: np.ndarray,
    max_planes: int = 20,
    min_area: int = 100,
    depth_tolerance: float = 0.1,
    max_mean_error: float = 1.0,
):
    """Returns (label_map, params [M, 3]) or None if the frame is rejected."""
    seg_path = os.path.join(scene_dir, "annotation", "segmentation", f"{frame_id}.png")
    depth_path = os.path.join(scene_dir, "depth", f"{frame_id}.png")
    pose_path = os.path.join(scene_dir, "pose", f"{frame_id}.txt")
    if not (os.path.exists(seg_path) and os.path.exists(pose_path)):
        return None
    seg_rgb = read_png_or_none(seg_path)  # RGB order: no swap
    if seg_rgb is None:
        return None
    global_ids = decode_packed_segmentation(seg_rgb)

    pose = np.loadtxt(pose_path)
    if not np.all(np.isfinite(pose)):
        return None
    extrinsic = np.linalg.inv(pose)

    depth = None
    if os.path.exists(depth_path):
        d = read_png_or_none(depth_path)
        if d is not None:
            depth = d.astype(np.float64) / 1000.0
            if depth.shape != global_ids.shape:
                depth = resize_nearest(depth, *global_ids.shape)

    # remap global ids present in this frame to 0..M-1
    present = [g for g in np.unique(global_ids) if g >= 0 and g < len(planes_world)]
    label = np.full(global_ids.shape, NON_PLANAR, np.int32)
    params_w = []
    for i, g in enumerate(present[:max_planes]):
        label[global_ids == g] = i
        params_w.append(planes_world[g])
    if not params_w:
        return None
    params_w = np.stack(params_w)

    params_cam = transform_planes(extrinsic, params_w)

    if depth is not None:
        K_inv = np.linalg.inv(K)
        label = clean_plane_segmentation(
            label, params_cam, depth, K_inv,
            depth_tolerance=depth_tolerance, min_area=min_area,
        )
        # frame-level rejection: mean |plane depth - measured| over plane px
        live = [l for l in np.unique(label) if l != NON_PLANAR]
        if not live:
            return None
        pd = plane_depth_map(params_cam[live], K_inv, *label.shape)
        errs = []
        for k, l in enumerate(live):
            m = (label == l) & (depth > 1e-4)
            if m.sum():
                errs.append(np.abs(pd[k][m] - depth[m]).mean())
        if errs and np.mean(errs) > max_mean_error:
            return None

    params_cam, label = merge_coplanar_planes(params_cam, label)
    if len(params_cam) == 0:
        return None
    return label, params_cam


def prepare_scene(
    scene_dir: str,
    out_suffix: str = "003",
    max_planes: int = 20,
    num_workers: int = 4,
    limit: Optional[int] = None,
) -> int:
    """Process every annotated frame of a scene; returns frames written."""
    planes_path = os.path.join(scene_dir, "annotation", "planes.npy")
    planes_world = np.load(planes_path).reshape(-1, 3)
    K4 = np.loadtxt(os.path.join(scene_dir, "intrinsic", "intrinsic_depth.txt"))
    K = K4[:3, :3]

    seg_dir = os.path.join(scene_dir, "annotation", "segmentation")
    frame_ids = sorted(
        os.path.splitext(f)[0] for f in os.listdir(seg_dir) if f.endswith(".png")
    )
    if limit:
        frame_ids = frame_ids[:limit]

    out_seg = os.path.join(scene_dir, f"planercnn_seg_{out_suffix}")
    out_para = os.path.join(scene_dir, f"planercnn_para_{out_suffix}")
    os.makedirs(out_seg, exist_ok=True)
    os.makedirs(out_para, exist_ok=True)

    def work(fid: str) -> bool:
        result = prepare_frame(scene_dir, fid, planes_world, K, max_planes)
        if result is None:
            return False
        label, params = result
        write_png(os.path.join(out_seg, f"{fid}.png"), label.astype(np.uint8))
        np.save(os.path.join(out_para, f"{fid}.npy"), params.astype(np.float32))
        return True

    with ThreadPoolExecutor(num_workers) as pool:
        written = sum(pool.map(work, frame_ids))
    return written
