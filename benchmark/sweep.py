"""The knee of the open-loop serving path: the highest offered rate at which
the requests answered inside the window stay at 95% or more of those due.

    python3 -m benchmark.sweep --workload serve-3v-open --rates 120,150,180 [--seconds 8]
        [--seed 1]

runs the cell's traffic at each rate in turn against one session built
once, and prints one JSON line a rate, then the knee. The cells' rates are
fixed fractions of a knee found this way once, and written into their
traffic files as numbers.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from benchmark import run
    from benchmark.drivers import open_loop

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = run.load_spec(args.workload)
    ctx = run.Context(spec, args.seed, args.seconds, False, "cuda", run.T_START)
    session, state = open_loop.build(ctx)
    knee = None
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        ctx.traffic = dict(spec.traffic, rate_rps=rate)
        ctx.seed = args.seed + i
        ctx.windows = []
        r = open_loop.measure(ctx, session, state)
        lat = r["due_latency_ms"]
        row = {"offered_rps": rate, "due": r["attempted"],
               "answered_rps": r["answered_in_window"] / args.seconds,
               "ratio": r["answered_in_window"] / r["attempted"],
               "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
               "p99_ms": float(np.percentile(lat, 99)), "mean_batch": r["served"] / max(r["dispatched"], 1),
               "failed": r["failed"], "generator_late_ms": r["generator_late_ms"]}
        print(json.dumps(row), flush=True)
        if row["ratio"] >= 0.95 and row["failed"] == 0:
            knee = rate
    print(json.dumps({"knee_rps": knee, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
