"""Train-step time by the chain slope (``tools/step_time_slope.py``).

Runs K bf16 train steps (``model.compute_dtype=bfloat16``, 64 planes) on
one seeded synthetic batch on the device, then one ``float(loss)`` that
waits for the whole chain, for each K; the slope between the last two K is
the time a step takes, launch and fetch costs in the intercept.

    python -m cnmnet_tpu_torch.tools.step_time_slope [batch] [ks, default 4,16,48]
        [--height H --width W] [--device cuda] [dotted.overrides=...]
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import device_name
    from cnmnet_tpu_torch.serve import resolve_device
    from cnmnet_tpu_torch.tools._batch import tiny_batch
    from cnmnet_tpu_torch.tools.roofline import train_config
    from cnmnet_tpu_torch.train.loop import make_train_step
    from cnmnet_tpu_torch.train.state import create_train_state

    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=2)
    ap.add_argument("ks", nargs="?", default="4,16,48")
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", default=[])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ks = [int(k) for k in args.ks.split(",")]
    cfg = train_config(args.batch, args.height, args.width, args.overrides)
    batch = tiny_batch(args.batch, args.height, args.width, device=device)
    state = create_train_state(cfg, 0, device)
    step = make_train_step(cfg)
    print(f"device: {device_name(device)}")

    state, metrics = step(state, batch)  # first-call costs
    float(metrics["loss"])
    results = []
    for k in ks:
        t0 = time.monotonic()
        for _ in range(k):
            state, metrics = step(state, batch)
        loss = float(metrics["loss"])  # waits for the whole chain
        dt = time.monotonic() - t0
        results.append((k, dt))
        print(f"K={k:3d}: {dt:7.3f} s total, loss {loss:.4f}", flush=True)

    (k1, t1), (k2, t2) = results[-2], results[-1]
    slope = (t2 - t1) / (k2 - k1)
    print(f"slope: {slope * 1e3:.2f} ms/step ({args.batch / slope:.2f} samples/s, batch "
          f"{args.batch}); intercept ~{(t1 - slope * k1) * 1e3:.0f} ms")
    print(json.dumps({"batch": args.batch, "ms_per_step": slope * 1e3,
                      "samples_per_s": args.batch / slope, "intercept_ms": (t1 - slope * k1) * 1e3,
                      "height": args.height, "width": args.width}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
