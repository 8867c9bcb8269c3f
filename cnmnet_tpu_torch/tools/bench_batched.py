"""Batched 3-view refined inference throughput: frames/s against the batch
(``tools/bench_batched.py``).

``cnmnet_tpu_torch/bench.py`` times batch 1, the reference's per-frame
eval loop; batching frames amortises the per-op launch cost that bounds
batch 1 on the host. For each batch this prints frames/s of bench's
forward (same model, same kernels) by the chain slope, the time of the
first call, and one JSON object.

    python -m cnmnet_tpu_torch.tools.bench_batched [--batches 1,4,8] [--iters 40]
        [--height 192 --width 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import build_model, chain_lengths, device_name, make_forward
    from cnmnet_tpu_torch.obs.timing import forward_slope_seconds
    from cnmnet_tpu_torch.serve import resolve_device
    from cnmnet_tpu_torch.tools._batch import tiny_batch

    p = argparse.ArgumentParser()
    p.add_argument("--batches", default="1,4,8")
    p.add_argument("--iters", type=int, default=None,
                   help="long chain of the slope (default: bench's 40 on the card)")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device_name(device)}")
    forward = make_forward(build_model(device))
    k1, k2 = chain_lengths(device, args.iters)
    for bs in (int(b) for b in args.batches.split(",")):
        batch = tiny_batch(bs, args.height, args.width, device=device)
        images, cams = batch["images"], batch["cams"]
        t0 = time.monotonic()
        forward(images, cams)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        first_s = time.monotonic() - t0
        dt = forward_slope_seconds(forward, images, cams, k1=k1, k2=k2)
        print(f"batch {bs:3d}: {bs / dt:8.2f} frames/s ({dt * 1e3:7.3f} ms/call; first call "
              f"{first_s:.2f} s)")
        print(json.dumps({"batch": bs, "frames_per_s": bs / dt, "ms_per_call": dt * 1e3,
                          "first_call_s": first_s, "height": args.height, "width": args.width}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
