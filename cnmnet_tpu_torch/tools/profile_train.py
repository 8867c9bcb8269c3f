"""Device profile of the train step: the top device ops by total time
(``tools/profile_train.py``).

The step is ``train/loop.make_train_step`` (forward, the CNM loss,
backward, Adam) on one seeded synthetic batch on the device, in bf16 on the
card (``model.compute_dtype=bfloat16``) and f32 on the CPU, as the JAX
tool picks bf16 off the CPU. Prints the first step's seconds, the wall ms
per step over ``--iters`` steps ended by one ``float(loss)`` (the number to
trust), then, unless ``--no-trace``, ``--iters`` traced steps: device time
per step by kernel and by class (``profile_forward.TRAIN_KERNEL_CLASSES``)
and the device's idle share.

    python -m cnmnet_tpu_torch.tools.profile_train [--batch 2] [--iters 10] [--top 30]
        [--height 192 --width 256] [--remat] [--no-trace] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from cnmnet_tpu_torch.tools.profile_forward import (TRAIN_KERNEL_CLASSES, by_class, device_rows,
                                                    report, trace)


def profile_step(step, state, batch):
    """One traced train step on the card after one untraced
    (``profile_forward.trace``): wall ms under the profiler, device busy ms
    (the sum of kernel times), ms by kernel class, ``(name, ms, count)`` per
    kernel, and the device span of the plain depth->normal backward (the
    ``depth_to_normal_backward`` range of ``DepthToNormal.backward``: first
    to last kernel, gaps included)."""
    wall_ms, prof = trace(lambda: step(state, batch), 1, torch.device("cuda"))
    rows = device_rows(prof)
    nb = [e for e in prof.key_averages() if e.key == "depth_to_normal_backward"]
    nb_ms = nb[0].device_time_total / 1e3 if nb else None
    return wall_ms, sum(r[1] for r in rows), by_class(rows, TRAIN_KERNEL_CLASSES), rows, nb_ms


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import device_name
    from cnmnet_tpu_torch.config import Config, apply_overrides
    from cnmnet_tpu_torch.serve import resolve_device
    from cnmnet_tpu_torch.tools._batch import tiny_batch
    from cnmnet_tpu_torch.train.loop import make_train_step
    from cnmnet_tpu_torch.train.state import create_train_state

    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--no-trace", action="store_true", help="wall clock only")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = apply_overrides(Config(), [
        f"dataset.batch_size={args.batch}", f"dataset.image_height={args.height}",
        f"dataset.image_width={args.width}", "model.num_planes=64",
        f"model.remat={str(args.remat).lower()}",
    ] + (["model.compute_dtype=bfloat16"] if device.type == "cuda" else []))
    batch = tiny_batch(args.batch, args.height, args.width, device=device)
    state = create_train_state(cfg, 0, device)
    step = make_train_step(cfg)
    print(f"device: {device_name(device)}; train step, batch {args.batch}, "
          f"{args.height}x{args.width}, {cfg.model.compute_dtype}, remat={args.remat}")

    t0 = time.monotonic()
    state, metrics = step(state, batch)
    float(metrics["loss"])
    print(f"first step: {time.monotonic() - t0:.2f} s", flush=True)
    t0 = time.monotonic()
    for _ in range(args.iters):
        state, metrics = step(state, batch)
    float(metrics["loss"])
    dt = (time.monotonic() - t0) / args.iters
    print(f"wall clock: {dt * 1e3:.2f} ms/step ({args.batch / dt:.2f} samples/s, batch "
          f"{args.batch})", flush=True)
    summary = {"batch": args.batch, "step_ms": dt * 1e3, "remat": args.remat}
    if not args.no_trace:
        wall_ms, prof = trace(lambda: step(state, batch), args.iters, device)
        summary.update(report(prof, wall_ms, args.iters, args.top, device,
                              TRAIN_KERNEL_CLASSES))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
