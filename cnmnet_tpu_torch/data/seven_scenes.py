"""7-Scenes cross-dataset evaluation loader (``cnmnet_tpu/data/seven_scenes.py``).

Parity with the reference's ``LoadSevenScenes`` (`eval.py:26-159`): the 18
fixed test sequences, fx = fy = 585 intrinsics, per-frame files
``frame-XXXXXX.{color.png, depth.png, pose.txt}`` with pose = camera->world
(inverted to the extrinsic), RGB resized bilinear + ImageNet-normalized, K
rescaled; GT depth kept at native 640x480 for metric computation.

Decoding and resizing go through ``data/imageio`` (numpy, no cv2): the
uint8 RGB is resized with cv2's fixed-point ``INTER_LINEAR`` bit for bit,
then normalised, as the JAX loader does with cv2.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from cnmnet_tpu_torch.data.cameras import make_cam_array, scale_cam_array
from cnmnet_tpu_torch.data.imageio import read_png, resize_linear_u8
from cnmnet_tpu_torch.data.pipeline import normalize_images

TEST_SEQS: List[Tuple[str, str]] = [
    ("chess", "seq-03"),
    ("chess", "seq-05"),
    ("fire", "seq-03"),
    ("fire", "seq-04"),
    ("heads", "seq-01"),
    ("office", "seq-02"),
    ("office", "seq-06"),
    ("office", "seq-07"),
    ("office", "seq-09"),
    ("pumpkin", "seq-01"),
    ("pumpkin", "seq-07"),
    ("redkitchen", "seq-03"),
    ("redkitchen", "seq-04"),
    ("redkitchen", "seq-06"),
    ("redkitchen", "seq-12"),
    ("redkitchen", "seq-14"),
    ("stairs", "seq-01"),
    ("stairs", "seq-04"),
]

INTRINSICS = np.asarray(
    [[585.0, 0.0, 320.0], [0.0, 585.0, 240.0], [0.0, 0.0, 1.0]], np.float32
)


class SevenScenes:
    def __init__(
        self,
        root_dir: str,
        image_height: int = 192,
        image_width: int = 256,
        wire_dtype: str = "float32",
    ):
        assert wire_dtype in ("float32", "uint8"), wire_dtype
        self.root_dir = root_dir
        self.h = image_height
        self.w = image_width
        self.wire_dtype = wire_dtype
        self.test_seqs_list = TEST_SEQS

    def frame_paths(self, scene: str, seq: str) -> List[Dict[str, str]]:
        seq_dir = os.path.join(self.root_dir, scene, seq)
        out = []
        if not os.path.isdir(seq_dir):
            # partial datasets are common; the protocol's other sequences
            # still evaluate
            return out
        for filename in sorted(os.listdir(seq_dir)):
            if "color" in filename:
                out.append(
                    {
                        "rgb": os.path.join(seq_dir, filename),
                        "depth": os.path.join(seq_dir, filename.replace("color", "depth")),
                        "pose": os.path.join(
                            seq_dir, filename.replace("color.png", "pose.txt")
                        ),
                        "name": filename.replace(".color.png", ""),
                    }
                )
        return out

    def load_frame(self, paths: Dict[str, str], with_depth: bool = True):
        """Returns (rgb [h, w, 3] normalized (uint8 on the uint8 wire),
        gt_depth [480, 640] | None, cam [2, 4, 4])."""
        rgb = read_png(paths["rgb"])
        oh, ow = rgb.shape[:2]
        rgb = resize_linear_u8(rgb, self.h, self.w)
        if self.wire_dtype != "uint8":  # u8 wire: ships the resized uint8
            # as-is; normalization runs on the device (ops/images.prepare_images)
            rgb = normalize_images(rgb.astype(np.float32) / 255.0)

        pose = np.loadtxt(paths["pose"], dtype=np.float32)
        if not np.all(np.isfinite(pose)):
            raise ValueError(f"invalid pose {paths['pose']}")
        extrinsic = np.linalg.inv(pose)  # camera->world -> world->camera
        cam = make_cam_array(extrinsic, INTRINSICS)
        cam = scale_cam_array(cam, self.w / ow, self.h / oh)

        depth = None
        if with_depth:
            depth = read_png(paths["depth"]).astype(np.float32) / 1000.0
            depth[depth > 60.0] = 0.0  # 7-Scenes invalid marker 65535 mm
        return rgb, depth, cam
