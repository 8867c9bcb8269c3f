"""ScanNet multi-view dataset (host-side, numpy).

Feature parity with the reference's `scannet/dataloader_batch.py` /
`dataloader_pixel_normal.py` plus the plane fields its shipped loader
*dropped* but `train.py:147-162` consumes (SURVEY.md §2.16): disparity,
plane seg / instance masks, plane counts, and plane-parameter normals.

Per-sample directory layout under ``root_dir/<scene_id>/``:
  rgb/<id>.jpg, depth/<id>.png (mm), lg_normal/<id>.npy (or .png fallback,
  16-bit, (v/65535 - 0.5) * 2), cameras/<id>_cam.txt,
  planercnn_seg_003/<id>.png (label map, max label = non-planar -> 20),
  planercnn_para_003/<id>.npy (per-plane params).

Processing parity:
* RGB: BGR->RGB, ImageNet normalize;
* depth: /1000, clamp-to-0 outside [0.1, depth_scale] (`:112-124`);
* disparity: 1/(depth + 1e-4), clamp-to-0 outside [0.02, 3.0] (the
  commented-out recipe at `dataloader_batch.py:117-119`);
* resize: bilinear for rgb, nearest for depth/normal/segs, K rescaled
  (`Resizer`, `:242-350`);
* source views (ref id ± interval * i) load rgb + camera only;
* plane-para coordinate swap y<->z (PlaneRCNN frame, `:218-229`).

A copy of ``cnmnet_tpu/data/scannet.py`` for the port, with its two
paths for the RGB and depth frames:

* ``use_native=True`` (the default, as in JAX): where the native loader
  builds (``data/native``, ``available()``), the RGB JPEGs are decoded,
  resized and normalised (or kept uint8) and the depth PNGs decoded,
  resized and clamped in C++, and the reference frame's size comes from its
  JPEG header. This path needs no cv2 at all;
* otherwise (``use_native=False``, or no native loader) the JAX loader's
  cv2 path: JPEGs through cv2, imported inside ``_load_rgb`` only (the
  loader raises without it, as the JAX loader does), PNGs through
  ``data/imageio`` (numpy), the RGB resized as float32 in [0, 1] with cv2's
  float ``INTER_LINEAR`` (``imageio.resize_linear_f32``).

Normals and plane fields take ``imageio`` and ``INTER_NEAREST`` on both
paths. ``ScanNetDataset.path`` ("native" or "cv2") says which path every
sample of a dataset takes.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from cnmnet_tpu_torch.data.cameras import load_cam_text, scale_cam_array
from cnmnet_tpu_torch.data.imageio import read_png, resize_linear_f32, resize_nearest
from cnmnet_tpu_torch.data.pipeline import normalize_images, quantize_images_u8


class ScanNetDataset:
    def __init__(
        self,
        list_filepath: str,
        root_dir: str,
        view_num: int = 3,
        interval: int = 10,
        depth_scale: float = 5.0,
        image_height: int = 192,
        image_width: int = 256,
        max_planes: int = 20,
        load_planes: bool = True,
        normal_source: str = "lg_normal",  # or "normal_color" (png /255 variant)
        use_native: bool = True,
        wire_dtype: str = "float32",  # "uint8": raw RGB on the wire, 4x
        # smaller H2D; normalization then runs on the device
        # (ops/images.prepare_images)
    ):
        assert wire_dtype in ("float32", "uint8"), wire_dtype
        # C++ decode/resize/normalize path (GIL-free); cv2 otherwise
        self._native = None
        if use_native:
            from cnmnet_tpu_torch.data import native

            if native.available():
                self._native = native
        self.path = "cv2" if self._native is None else "native"
        self.root_dir = root_dir
        self.view_num = view_num
        self.interval = interval
        self.depth_scale = depth_scale
        self.h = image_height
        self.w = image_width
        self.max_planes = max_planes
        self.load_planes = load_planes
        self.normal_source = normal_source
        self.wire_dtype = wire_dtype
        with open(list_filepath) as f:
            self.sample_list: List[List[str]] = [
                line.split() for line in f if line.strip()
            ]

    def __len__(self):
        return len(self.sample_list)

    # --- individual field loaders ---------------------------------------

    def _path(self, scene: str, sub: str, name: str) -> str:
        return os.path.join(self.root_dir, scene, sub, name)

    def _load_rgb(self, scene: str, image_id: str) -> np.ndarray:
        try:
            import cv2  # JPEG: the one decode the port leaves to cv2
        except ImportError as e:
            raise RuntimeError("ScanNetDataset requires cv2") from e
        path = self._path(scene, "rgb", image_id + ".jpg")
        rgb = cv2.imread(path, -1)
        if rgb is None:
            raise FileNotFoundError(path)
        rgb = cv2.cvtColor(rgb, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        return rgb

    def _load_depth(self, scene: str, image_id: str) -> np.ndarray:
        depth = read_png(self._path(scene, "depth", image_id + ".png")).astype(
            np.float32
        ) / 1000.0
        depth[(depth < 0.1) | (depth > self.depth_scale)] = 0.0
        return depth

    def _load_normal(self, scene: str, image_id: str) -> np.ndarray:
        if self.normal_source == "lg_normal":
            npy = self._path(scene, "lg_normal", image_id + ".npy")
            if os.path.exists(npy):
                normal = np.load(npy).astype(np.float32)
            else:
                png = read_png(npy.replace("npy", "png")).astype(np.float32)
                normal = (png / 65535.0 - 0.5) * 2.0
        else:  # the dataloader_pixel_normal.py variant: 8-bit color normals
            png = read_png(self._path(scene, "normal_color", image_id + ".png"))
            png = png.astype(np.float32)
            normal = (png / 255.0 - 0.5) * 2.0
        return np.where(np.isnan(normal), 0.0, normal)

    def _load_cam(self, scene: str, image_id: str) -> np.ndarray:
        with open(self._path(scene, "cameras", image_id + "_cam.txt")) as f:
            return load_cam_text(f.read())

    def _load_plane_fields(self, scene: str, image_id: str, shape):
        """seg label map (non-planar -> 20), compacted instance masks,
        per-plane params (y<->z swapped), plane count, plane-para normals."""
        H, W = shape
        seg_path = self._path(scene, "planercnn_seg_003", image_id + ".png")
        para_path = self._path(scene, "planercnn_para_003", image_id + ".npy")
        if not (os.path.exists(seg_path) and os.path.exists(para_path)):
            return (
                np.full((H, W), 20, np.int32),
                np.zeros((self.max_planes, H, W), np.float32),
                np.zeros((self.max_planes, 3), np.float32),
                np.int32(0),
                np.zeros((H, W, 3), np.float32),
            )
        seg = read_png(seg_path).astype(np.int32)
        seg[seg == seg.max()] = 20  # non-planar
        para = np.load(para_path).astype(np.float32).reshape(-1, 3)
        # PlaneRCNN coordinate swap (`dataloader_batch.py:218-229`)
        para = para.copy()
        tmp = para[:, 1].copy()
        para[:, 1] = -para[:, 2]
        para[:, 2] = tmp

        # compact labels to 0..n-1, keeping planes with >= 100 px
        new_seg = np.full_like(seg, 20)
        new_para = []
        i = 0
        for label in np.unique(seg):
            if label == 20:
                continue
            mask = seg == label
            if mask.sum() < 100 or i >= self.max_planes:
                continue
            new_seg[mask] = i
            new_para.append(para[label] if label < len(para) else np.zeros(3))
            i += 1
        planes_num = i
        paras = np.zeros((self.max_planes, 3), np.float32)
        if new_para:
            paras[: len(new_para)] = np.stack(new_para)
        instance = np.zeros((self.max_planes, H, W), np.float32)
        for k in range(planes_num):
            instance[k] = new_seg == k
        # normal map from plane parameters (`dataloader_batch.py:231-239`)
        normal_pp = np.zeros((H, W, 3), np.float32)
        for k in range(planes_num):
            normal_pp[new_seg == k] = paras[k]
        normal_pp /= np.linalg.norm(normal_pp, axis=2, keepdims=True) + 1e-5
        return new_seg, instance, paras, np.int32(planes_num), normal_pp

    # --- sample assembly --------------------------------------------------

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        scene, ref_id = self.sample_list[index][0], self.sample_list[index][1]

        rgbs, cams, depths = [], [], []
        view_ids = [ref_id]
        for view in range(self.view_num):
            i = view - self.view_num // 2
            if i == 0:
                continue
            view_ids.append(str(int(ref_id) + self.interval * i))

        native = self._native
        if native is not None:
            oh, ow = native.jpeg_size(self._path(scene, "rgb", ref_id + ".jpg"))
        else:
            ref_rgb = self._load_rgb(scene, ref_id)
            oh, ow = ref_rgb.shape[:2]
        sx, sy = self.w / ow, self.h / oh

        for vi, image_id in enumerate(view_ids):
            if native is not None:
                rgb_path = self._path(scene, "rgb", image_id + ".jpg")
                if self.wire_dtype == "uint8":
                    rgbs.append(native.load_rgb_u8(rgb_path, self.w, self.h))
                else:
                    rgbs.append(native.load_rgb_normalized(rgb_path, self.w, self.h))
            else:
                rgb = self._load_rgb(scene, image_id) if vi else ref_rgb
                rgbs.append(resize_linear_f32(rgb, self.h, self.w))
            cams.append(scale_cam_array(self._load_cam(scene, image_id), sx, sy))
            # depth for every view: the warped-depth loss needs source GT
            # depth (`train.py:287-293`) even though the reference's shipped
            # loader only returned the reference depth.
            try:
                if native is not None:
                    depths.append(native.load_depth_meters(
                        self._path(scene, "depth", image_id + ".png"),
                        self.w, self.h, 0.1, self.depth_scale))
                else:
                    d = self._load_depth(scene, image_id)
                    depths.append(resize_nearest(d, self.h, self.w))
            except (FileNotFoundError, IOError):
                depths.append(np.zeros((self.h, self.w), np.float32))

        normal = self._load_normal(scene, ref_id)
        normal = resize_nearest(normal, self.h, self.w)

        depth_ref = depths[0]
        disparity = np.reciprocal(depth_ref + 1e-4)
        disparity[(disparity < 0.02) | (disparity > 3.0)] = 0.0

        # the native loader normalizes (or keeps u8) during resize; the cv2
        # path carries [0, 1] floats here and converts to the wire format
        images = np.stack(rgbs)
        if native is None:
            if self.wire_dtype == "uint8":
                images = quantize_images_u8(images)
            else:
                images = normalize_images(images)
        sample = {
            "images": images,
            "depths": np.stack(depths).astype(np.float32),
            "cams": np.stack(cams).astype(np.float32),
            "normals": normal.astype(np.float32),
            "disparity": disparity.astype(np.float32),
            "index": np.int32(index),
        }
        if self.load_planes:
            seg, instance, paras, planes_num, normal_pp = self._load_plane_fields(
                scene, ref_id, (oh, ow)
            )
            sample["plane_segs"] = resize_nearest(
                seg.astype(np.float32), self.h, self.w
            ).astype(np.int32)
            inst_r = np.zeros((self.max_planes, self.h, self.w), np.uint8)
            for k in range(self.max_planes):
                inst_r[k] = resize_nearest(instance[k], self.h, self.w)
            sample["instance_segs"] = inst_r
            sample["plane_paras"] = paras
            sample["planes_num"] = planes_num
            sample["normals_from_plane_para"] = resize_nearest(
                normal_pp, self.h, self.w
            )
        else:
            sample["instance_segs"] = np.zeros(
                (self.max_planes, self.h, self.w), np.uint8
            )
            sample["planes_num"] = np.int32(0)
        return sample
