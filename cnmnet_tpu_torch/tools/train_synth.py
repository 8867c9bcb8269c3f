"""Synthetic-domain training with the pool held on the device, then a
held-out evaluation (``tools/train_synth.py``).

Trains the full CNM recipe (``train/loop.make_train_step``) on ``--pool``
procedurally generated scenes (``data/synthetic``), collated and
normalised once and kept on the device, drawing a batch at random each
step; bf16 compute on the card (``model.compute_dtype=bfloat16``), f32 on
the CPU. Saves the final state under ``--out`` (a port checkpoint), then
scores the refined depth on ``--eval-scenes`` fresh scenes of another seed
(``ops/metrics.compute_errors`` within 0.3-8 m).

    python -m cnmnet_tpu_torch.tools.train_synth --steps 10000 --pool 96 --lr 3e-5
        [--resume DIR] [--out checkpoints_synth] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _sample(ds, i):
    """Scene ``i`` of ``ds`` with normalised images and no ``index``."""
    from cnmnet_tpu_torch.data.pipeline import normalize_images

    s = dict(ds[i])
    s.pop("index", None)
    s["images"] = normalize_images(s["images"])
    return s


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import device_name
    from cnmnet_tpu_torch.config import Config, apply_overrides
    from cnmnet_tpu_torch.data.pipeline import collate
    from cnmnet_tpu_torch.data.synthetic import SyntheticScenes
    from cnmnet_tpu_torch.ops import metrics as M
    from cnmnet_tpu_torch.serve import resolve_device
    from cnmnet_tpu_torch.train.checkpoint import CheckpointManager
    from cnmnet_tpu_torch.train.loop import batch_to_device, make_train_step
    from cnmnet_tpu_torch.train.state import create_train_state

    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--pool", type=int, default=96)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default="")
    p.add_argument("--out", default="checkpoints_synth")
    p.add_argument("--eval-scenes", type=int, default=3)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--print-every", type=int, default=500)
    p.add_argument("--overrides", default="",
                   help="comma-separated extra config overrides, e.g. "
                        "'model.remat=true,model.remat_stages=2,model.remat_refiner=true'")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = apply_overrides(Config(), [
        f"dataset.batch_size={args.batch}", f"dataset.image_height={args.height}",
        f"dataset.image_width={args.width}", "model.num_planes=64", f"solver.lr={args.lr}",
    ] + (["model.compute_dtype=bfloat16"] if device.type == "cuda" else [])
        + [o for o in args.overrides.split(",") if o])
    print(f"device: {device_name(device)}; {cfg.model.compute_dtype}", flush=True)

    ds = SyntheticScenes(num_samples=args.pool, height=args.height, width=args.width,
                         view_num=3, seed=args.seed)
    t0 = time.monotonic()
    pool = []
    for start in range(0, args.pool, args.batch):
        idx = [(start + j) % args.pool for j in range(args.batch)]
        pool.append(batch_to_device(collate([_sample(ds, i) for i in idx]), device))
    print(f"staged a {args.pool}-scene pool on {device} in {time.monotonic() - t0:.2f} s",
          flush=True)

    state = create_train_state(cfg, 0, device)
    start_step = 0
    mgr = CheckpointManager(os.path.abspath(args.out), device=device)
    if args.resume:
        state = mgr.restore(os.path.abspath(args.resume), state)
        start_step = state.step
        print(f"resumed from {args.resume} at step {start_step}", flush=True)

    step = make_train_step(cfg)
    rng = np.random.default_rng(args.seed + 1)
    loss = float("nan")
    t0 = time.monotonic()
    for it in range(args.steps):
        state, metrics = step(state, pool[int(rng.integers(len(pool)))])
        if (it + 1) % args.print_every == 0 or it + 1 == args.steps:
            loss = float(metrics["loss"])  # waits for the chain
            dt = (time.monotonic() - t0) / (it + 1)
            print(f"step {start_step + it + 1}: loss {loss:.4f} ({dt * 1e3:.1f} ms/step incl. "
                  "sync)", flush=True)
            if not np.isfinite(loss):
                raise SystemExit("loss non-finite; aborting")
    ms_per_step = (time.monotonic() - t0) / max(args.steps, 1) * 1e3
    final_step = start_step + args.steps
    mgr.save(state, step=final_step)
    print(f"saved {args.out}/{final_step}", flush=True)

    # held-out eval: fresh scenes from a disjoint seed
    hold = SyntheticScenes(num_samples=args.eval_scenes, height=args.height, width=args.width,
                           view_num=3, seed=args.seed + 777)
    model = state.model.eval()
    rows = []
    for i in range(args.eval_scenes):
        s = collate([_sample(hold, i)])
        with torch.inference_mode():
            out = model(torch.from_numpy(s["images"]).to(device),
                        torch.from_numpy(s["cams"]).to(device))
        idepth = out.idepth_refined.float().cpu().numpy()
        pred = 1.0 / np.clip(idepth[0, :, :, 0], 1e-2, None)
        gt = s["depths"][0, 0]
        mask = M.compute_valid_depth_mask(gt)
        rows.append(M.compute_errors(np.clip(pred, 0.3, 8.0)[mask], gt[mask]))
    agg = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    print("held-out:", {k: round(v, 4) for k, v in agg.items()}, flush=True)
    print(json.dumps({"steps": args.steps, "final_step": final_step, "loss": loss,
                      "ms_per_step": ms_per_step, "held_out": agg}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
