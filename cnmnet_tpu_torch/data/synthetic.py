"""Procedural multi-view indoor scenes with exact ground truth.

A copy of ``cnmnet_tpu/data/synthetic.py`` (numpy only): the same seed gives
the same arrays in both packages.

The reference has no test data; this generator produces geometrically
consistent (rgb, depth, normal, camera, plane-instance) samples entirely in
numpy so the full training/eval stack runs — and can be validated — without
ScanNet on disk:

* a random "room": a floor plane, a back wall, and 1-3 random slanted
  planes, ray-cast per pixel (nearest positive intersection);
* per-view cameras with small random rotations/translations around the
  reference view, emitted in the packed [2, 4, 4] format;
* textured RGB (procedural sinusoid texture in *world* coordinates so
  cross-view photo-consistency holds — the plane-sweep has a real signal);
* exact depth, analytic normals, plane-instance masks (<= 20 slots) and
  per-plane parameters — everything the reference's loss stack consumes
  (SURVEY.md §2.16's reconstructed sample dict).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _normalize(v):
    return v / (np.linalg.norm(v) + 1e-12)


class SyntheticScenes:
    """Deterministic procedural dataset of multi-view samples."""

    def __init__(
        self,
        num_samples: int = 64,
        height: int = 192,
        width: int = 256,
        view_num: int = 3,
        max_planes: int = 20,
        seed: int = 123,
    ):
        self.num_samples = num_samples
        self.height = height
        self.width = width
        self.view_num = view_num
        self.max_planes = max_planes
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def _camera(self, rng) -> np.ndarray:
        H, W = self.height, self.width
        f = 0.9 * W * (0.9 + 0.2 * rng.random())
        K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
        return K

    def _planes(self, rng) -> List[Dict]:
        """Room planes in world frame: n . p = d with n unit, d > 0."""
        planes = []
        # back wall at z ~ 3-4 facing camera
        planes.append(dict(n=np.asarray([0.0, 0.0, -1.0]), d=-(3.0 + rng.random())))
        # floor below (y up in camera coords is down; use y-plane)
        planes.append(dict(n=np.asarray([0.0, -1.0, 0.0]), d=-(1.0 + 0.5 * rng.random())))
        for _ in range(rng.integers(1, 4)):
            n = _normalize(rng.standard_normal(3) * np.asarray([0.6, 0.6, 1.0]))
            if n[2] > 0:
                n = -n  # face the camera
            d = -(2.0 + 1.5 * rng.random())
            planes.append(dict(n=n, d=d))
        return planes

    def _pose(self, rng, view: int) -> np.ndarray:
        """World->camera extrinsic for a view; view 0 is the identity."""
        E = np.eye(4, dtype=np.float32)
        if view == 0:
            return E
        angle = 0.03 * rng.standard_normal(3)
        cx, cy, cz = np.cos(angle)
        sx, sy, sz = np.sin(angle)
        Rx = np.asarray([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.asarray([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        R = Rz @ Ry @ Rx
        t = 0.08 * rng.standard_normal(3)
        E[:3, :3] = R.astype(np.float32)
        E[:3, 3] = t.astype(np.float32)
        return E

    def _raycast(self, K: np.ndarray, E: np.ndarray, planes: List[Dict]):
        """Per-pixel nearest plane hit. Returns depth, normal(cam), label."""
        H, W = self.height, self.width
        uv = np.stack(
            [
                np.tile(np.arange(W, dtype=np.float64), (H, 1)),
                np.tile(np.arange(H, dtype=np.float64)[:, None], (1, W)),
                np.ones((H, W)),
            ]
        )  # [3, H, W]
        K_inv = np.linalg.inv(K.astype(np.float64))
        rays_cam = (K_inv @ uv.reshape(3, -1)).reshape(3, H, W)
        R = E[:3, :3].astype(np.float64)
        t = E[:3, 3].astype(np.float64)
        cam_origin_w = -R.T @ t
        rays_w = np.einsum("ij,jhw->ihw", R.T, rays_cam)

        best_t = np.full((H, W), np.inf)
        label = np.full((H, W), -1, np.int32)
        for li, pl in enumerate(planes):
            n, d = pl["n"], pl["d"]
            denom = np.einsum("i,ihw->hw", n, rays_w)
            with np.errstate(divide="ignore", invalid="ignore"):
                t_hit = (d - n @ cam_origin_w) / denom
            valid = (t_hit > 0.2) & np.isfinite(t_hit)
            closer = valid & (t_hit < best_t)
            best_t = np.where(closer, t_hit, best_t)
            label = np.where(closer, li, label)

        pts_w = cam_origin_w[:, None, None] + rays_w * best_t[None]
        depth = rays_cam[2] * best_t  # z-depth in the camera frame
        # camera-frame normals per pixel
        normals_w = np.stack([planes[max(l, 0)]["n"] for l in range(len(planes))])
        n_map_w = normals_w[np.maximum(label, 0)]  # [H, W, 3]
        n_map_cam = np.einsum("ij,hwj->hwi", R, n_map_w)
        # orient normals to satisfy n . p = 1 convention (toward the fit of
        # the depth->normal operator: solutions of (AtA)n = At1 have n.p ~ 1 > 0)
        pts_cam = np.einsum("ij,jhw->ihw", R, pts_w - (-R.T @ t)[:, None, None])
        dot = np.einsum("hwi,ihw->hw", n_map_cam, pts_cam)
        n_map_cam = np.where(dot[..., None] < 0, -n_map_cam, n_map_cam)

        bad = label < 0
        depth = np.where(bad, 0.0, depth)
        n_map_cam = np.where(bad[..., None], 0.0, n_map_cam)
        return (
            depth.astype(np.float32),
            n_map_cam.astype(np.float32),
            label,
            pts_w,
        )

    @staticmethod
    def _texture(pts_w: np.ndarray, label: np.ndarray) -> np.ndarray:
        """View-independent RGB from world position (photo-consistent)."""
        x, y, z = pts_w
        r = 0.5 + 0.25 * np.sin(7.1 * x) + 0.2 * np.cos(5.3 * y + 1.0)
        g = 0.5 + 0.25 * np.sin(6.3 * y + 2.0) + 0.2 * np.cos(4.7 * z)
        b = 0.5 + 0.25 * np.sin(5.9 * z + 4.0) + 0.2 * np.cos(6.7 * x + 3.0)
        rgb = np.stack([r, g, b], axis=-1)
        rgb += 0.05 * (label[..., None] % 5)
        return np.clip(rgb, 0.0, 1.0).astype(np.float32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + index)
        planes = self._planes(rng)
        K = self._camera(rng)

        rgbs, depths, cams = [], [], []
        normals = None
        label_ref = None
        for v in range(self.view_num):
            E = self._pose(rng, v)
            depth, n_cam, label, pts_w = self._raycast(K, E, planes)
            rgb = self._texture(pts_w, label)
            rgbs.append(rgb)
            depths.append(depth)
            cam = np.zeros((2, 4, 4), np.float32)
            cam[0] = E
            cam[1, :3, :3] = K
            cams.append(cam)
            if v == 0:
                normals = n_cam
                label_ref = label

        S = self.max_planes
        # uint8 on the wire: these cross host->device every step and the
        # plane ops cast to float in-graph anyway
        instance = np.zeros((S, self.height, self.width), np.uint8)
        planes_num = min(len(planes), S)
        for i in range(planes_num):
            instance[i] = label_ref == i

        depth_ref = depths[0]
        with np.errstate(divide="ignore"):
            disparity = np.where(depth_ref > 0, 1.0 / np.maximum(depth_ref, 1e-4), 0.0)
        disparity = np.where(
            (disparity < 0.02) | (disparity > 3.0), 0.0, disparity
        ).astype(np.float32)

        return {
            "images": np.stack(rgbs),  # [V, H, W, 3] in [0, 1]
            "depths": np.stack(depths),  # [V, H, W]
            "cams": np.stack(cams),  # [V, 2, 4, 4]
            "normals": normals,  # [H, W, 3] ref view, camera frame
            "disparity": disparity,  # [H, W] ref view
            "instance_segs": instance,  # [S, H, W]
            "planes_num": np.int32(planes_num),
            "index": np.int32(index),
        }

    def batches(
        self,
        batch_size: int,
        epochs: int = 1,
        normalize: bool = True,
        wire_dtype: str = "float32",
    ):
        """Yield collated numpy batches (see pipeline.collate).

        ``wire_dtype="uint8"`` ships raw uint8 RGB (4x smaller H2D; the
        ImageNet affine then runs in-graph — `ops/images.prepare_images`);
        the default ships host-normalized float32.
        """
        from cnmnet_tpu_torch.data.pipeline import (
            collate,
            normalize_images,
            quantize_images_u8,
        )

        for _ in range(epochs):
            for start in range(0, len(self), batch_size):
                idx = [(start + i) % len(self) for i in range(batch_size)]
                samples = [self[i] for i in idx]
                batch = collate(samples)
                if wire_dtype == "uint8":
                    batch["images"] = quantize_images_u8(batch["images"])
                elif normalize:
                    batch["images"] = normalize_images(batch["images"])
                yield batch


def train_data_fn(cfg):
    """The data function ``train.loop.train_loop`` takes for synthetic
    training, built as the JAX package's ``cli.py train --synthetic`` builds
    it: ``dataset.synthetic_size`` scenes of the configured size and views,
    seeded by ``train.seed``; each call yields one epoch of
    ``dataset.batch_size`` batches on the ``dataset.wire_dtype`` wire."""
    ds = SyntheticScenes(
        num_samples=cfg.dataset.synthetic_size,
        height=cfg.dataset.image_height,
        width=cfg.dataset.image_width,
        view_num=cfg.dataset.view_num,
        seed=cfg.train.seed,
    )

    def data_iter():
        return ds.batches(cfg.dataset.batch_size, epochs=1, wire_dtype=cfg.dataset.wire_dtype)

    return data_iter
