"""Train-step timing with a hard synchronisation each iteration, and the
loss of every step (``tools/verify_step_time.py``).

First the train-mode forward and the loss alone (``model(...)`` and
``compute_losses`` without a gradient, BatchNorm on batch statistics; the
running statistics it moves are put back, as JAX's ``mutable`` throws them
away): the mean of ``--reps`` calls, each synchronised. Then ``--reps``
full steps (``make_train_step``: forward, backward, Adam), each timed to a
synchronising fetch of its loss: median and min ms, and the losses (every
step ran and moved the weights). The difference of the two is the
backward and the optimizer. bf16 convs (``model.compute_dtype=bfloat16``),
64 planes, one seeded synthetic batch, as in JAX.

    python -m cnmnet_tpu_torch.tools.verify_step_time [batch, default 2]
        [--height 192 --width 256] [--reps 20] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import device_name
    from cnmnet_tpu_torch.kernels.dispatch import launch_counts
    from cnmnet_tpu_torch.ops.images import prepare_images
    from cnmnet_tpu_torch.serve import resolve_device
    from cnmnet_tpu_torch.tools._batch import tiny_batch
    from cnmnet_tpu_torch.tools.roofline import train_config
    from cnmnet_tpu_torch.train.loop import loss_weights_from_config, make_train_step
    from cnmnet_tpu_torch.train.losses import compute_losses
    from cnmnet_tpu_torch.train.state import create_train_state

    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=2)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = train_config(args.batch, args.height, args.width)
    batch = tiny_batch(args.batch, args.height, args.width, device=device)
    state = create_train_state(cfg, 0, device)
    step = make_train_step(cfg)
    w = loss_weights_from_config(cfg)
    model = state.model
    print(f"device: {device_name(device)}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @torch.no_grad()
    def fwd_loss():
        model.train()
        out = model(prepare_images(batch["images"]), batch["cams"])
        return compute_losses(out, batch, state.epoch, w)[0]

    before = launch_counts()
    saved = {n: b.clone() for n, b in model.named_buffers()}
    fwd_loss()
    sync()
    t0 = time.monotonic()
    for _ in range(args.reps):
        fwd_loss()
        sync()
    fwd_ms = (time.monotonic() - t0) / args.reps * 1e3
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(saved[n])
    print(f"train-mode fwd+loss: {fwd_ms:.2f} ms (batch {args.batch})")

    state, metrics = step(state, batch)
    float(metrics["loss"])
    losses, times = [], []
    for _ in range(args.reps):
        t0 = time.monotonic()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))  # the synchronising fetch
        times.append(time.monotonic() - t0)
    median, least = statistics.median(times) * 1e3, min(times) * 1e3
    print(f"full step (hard sync each iter): median {median:.2f} ms, min {least:.2f} ms "
          f"(batch {args.batch})")
    print("losses:", " ".join(f"{v:.4f}" for v in losses))
    print(json.dumps({"batch": args.batch, "height": args.height, "width": args.width,
                      "reps": args.reps, "fwd_loss_ms": fwd_ms, "step_median_ms": median,
                      "step_min_ms": least, "backward_and_update_ms": median - fwd_ms,
                      "losses": losses,
                      "launches": {k: v - before[k] for k, v in launch_counts().items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
