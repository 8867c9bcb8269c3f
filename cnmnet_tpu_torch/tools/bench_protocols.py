"""Per-protocol inference timing: view counts and resolutions
(``tools/bench_protocols.py``).

Times bench's refined forward (same model, same kernels) over the
reference's protocols, 3/5/7 views (``eval.py:408-415,586-592,822-830``),
at each of ``--sizes``, for example the 7-Scenes native 480x640. Each
line: frames/s and ms/frame by the chain slope, the first call's time, and
one JSON object.

    python -m cnmnet_tpu_torch.tools.bench_protocols [--views 3,5,7]
        [--sizes 192x256,480x640] [--iters 40] [--device cuda]
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
    p.add_argument("--views", default="3,5,7")
    p.add_argument("--sizes", default="192x256")
    p.add_argument("--iters", type=int, default=None,
                   help="long chain of the slope (default: bench's 40 on the card)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device_name(device)}")
    forward = make_forward(build_model(device))
    k1, k2 = chain_lengths(device, args.iters)
    for size in args.sizes.split(","):
        h, w = (int(v) for v in size.split("x"))
        for views in (int(v) for v in args.views.split(",")):
            batch = tiny_batch(1, h, w, views, device=device)
            images, cams = batch["images"], batch["cams"]
            t0 = time.monotonic()
            forward(images, cams)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            first_s = time.monotonic() - t0
            dt = forward_slope_seconds(forward, images, cams, k1=k1, k2=k2)
            print(f"{views}-view @ {h}x{w}: {1.0 / dt:7.2f} frames/s ({dt * 1e3:7.3f} ms/frame; "
                  f"first call {first_s:.2f} s)")
            print(json.dumps({"views": views, "height": h, "width": w, "frames_per_s": 1.0 / dt,
                              "ms_per_frame": dt * 1e3, "first_call_s": first_s}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
