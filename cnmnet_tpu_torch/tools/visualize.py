"""Render prediction panels (rgb | gt depth | pred depth | pred normal |
prob map) from a port checkpoint to PNG files (``tools/visualize.py``).

The weights come from a port checkpoint (``--checkpoint``: a manager root,
whose newest step is taken, or a step directory, as
``train/checkpoint.CheckpointManager.restore`` reads them); the forward is
bench's (``cnmnet_tpu_torch/bench.py``: the refined forward, then
depth->normal with ``model.k_size``), in f32, or bf16 with ``--bf16``.
Samples are synthetic scenes 60 and on (or the first of ``--scannet ROOT
LIST``). PNGs are written with ``data/imageio.write_png``.

    python -m cnmnet_tpu_torch.tools.visualize --checkpoint DIR --out DIR [--samples 2]
        [--scannet ROOT LIST] [--height 192 --width 256] [--bf16] [--device cuda]
        [dotted.overrides=...]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import make_forward
    from cnmnet_tpu_torch.config import Config, apply_overrides
    from cnmnet_tpu_torch.data.imageio import write_png
    from cnmnet_tpu_torch.data.pipeline import collate, denormalize_images, normalize_images
    from cnmnet_tpu_torch.models.cnm import cast_for_compute
    from cnmnet_tpu_torch.obs.colorize import colorize_depth, colorize_prob, normal_to_color
    from cnmnet_tpu_torch.serve import resolve_device
    from cnmnet_tpu_torch.train.checkpoint import CheckpointManager
    from cnmnet_tpu_torch.train.state import TrainState, build_model

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--samples", type=int, default=2)
    p.add_argument("--scannet", nargs=2, metavar=("ROOT", "LIST"), default=None)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("overrides", nargs="*", default=[],
                   help="dotted config overrides of the trained model (model.num_planes=...)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = apply_overrides(Config(), [f"dataset.image_height={args.height}",
                                     f"dataset.image_width={args.width}"] + args.overrides)

    if args.scannet:
        from cnmnet_tpu_torch.data.scannet import ScanNetDataset

        ds = ScanNetDataset(list_filepath=args.scannet[1], root_dir=args.scannet[0],
                            image_height=args.height, image_width=args.width)
        first = 0
    else:
        from cnmnet_tpu_torch.data.synthetic import SyntheticScenes

        ds = SyntheticScenes(num_samples=max(args.samples, 1) + 60, height=args.height,
                             width=args.width, view_num=3)
        first = 60
    batch = collate([{k: v for k, v in ds[first + i].items() if k != "index"}
                     for i in range(args.samples)])
    if not args.scannet:
        batch["images"] = normalize_images(batch["images"])

    model = build_model(cfg)
    path = os.path.abspath(args.checkpoint)
    try:
        state = CheckpointManager(path, device="cpu").restore(path, TrainState(model=model),
                                                              with_optimizer=False)
    except FileNotFoundError:
        print(f"no checkpoint found in {args.checkpoint}")
        return 1
    print(f"restored step {state.step}")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    forward = make_forward(cast_for_compute(model, dtype, device).eval(), cfg.model.k_size)
    images = torch.from_numpy(batch["images"]).to(device)
    cams = torch.from_numpy(batch["cams"]).to(device)
    idepth, prob, normals = forward(images, cams)
    pred_depth = (1.0 / (idepth[..., 0].float() + 1e-8)).cpu().numpy()
    normals, prob = normals.float().cpu().numpy(), prob.float().cpu().numpy()

    os.makedirs(args.out, exist_ok=True)
    for i in range(args.samples):
        rgb = np.clip(denormalize_images(batch["images"][i, 0]), 0, 1)
        panel = np.concatenate([
            (rgb * 255).astype(np.uint8),
            colorize_depth(batch["depths"][i, 0]),
            colorize_depth(pred_depth[i]),
            normal_to_color(normals[i]),
            colorize_prob(prob[i, ..., 0]),
        ], axis=1)
        out = os.path.join(args.out, f"sample_{i}.png")
        write_png(out, panel)
        print("wrote", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
