"""Sanity check: depth->normal against ground-truth normal maps
(``tools/check_gt_normal.py``, the counterpart of the reference's
``data_prepare/check_gt_normal.py:9-33``, its only golden-value script).

Runs depth->normal (``kernels/dispatch``: the kernel on the card) on each
sample's ground-truth depth and prints the mean angle to the ground-truth
normal map over pixels with depth above 0.1 (``ops/normals.
normal_mean_angle_deg``), per sample and overall.

    python -m cnmnet_tpu_torch.tools.check_gt_normal [--num-samples 4] [--k-size 9]
        [--height 192 --width 256] [--device cuda]           # synthetic scenes
    python -m cnmnet_tpu_torch.tools.check_gt_normal --scannet ROOT LIST   # ScanNet samples
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main(argv=None) -> int:
    from cnmnet_tpu_torch.geometry.camera import invert_intrinsics
    from cnmnet_tpu_torch.kernels import dispatch
    from cnmnet_tpu_torch.ops.normals import normal_mean_angle_deg
    from cnmnet_tpu_torch.serve import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--scannet", nargs=2, metavar=("ROOT", "LIST"), default=None)
    p.add_argument("--k-size", type=int, default=9)
    p.add_argument("--num-samples", type=int, default=4)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.scannet:
        from cnmnet_tpu_torch.data.scannet import ScanNetDataset

        ds = ScanNetDataset(list_filepath=args.scannet[1], root_dir=args.scannet[0],
                            image_height=args.height, image_width=args.width)
    else:
        from cnmnet_tpu_torch.data.synthetic import SyntheticScenes

        ds = SyntheticScenes(num_samples=args.num_samples, height=args.height, width=args.width)

    angles = []
    for i in range(min(args.num_samples, len(ds))):
        s = ds[i]
        depth = torch.from_numpy(np.asarray(s["depths"][0], np.float32))[None].to(device)
        K = torch.from_numpy(np.asarray(s["cams"][0, 1, :3, :3], np.float32))[None].to(device)
        n, _ = dispatch.depth_to_normal(depth, invert_intrinsics(K), args.k_size)
        gt = torch.from_numpy(np.asarray(s["normals"], np.float32))[None].to(device)
        angles.append(float(normal_mean_angle_deg(n, gt, depth > 0.1)))
        print(f"sample {i}: mean angle {angles[-1]:.4f} deg")
    print(f"overall mean angle: {np.mean(angles):.4f} deg")
    print(json.dumps({"samples": len(angles), "angles_deg": angles,
                      "mean_angle_deg": float(np.mean(angles))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
