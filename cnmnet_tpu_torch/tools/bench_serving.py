"""MicroBatcher load test: client latency against offered load, open loop
(``tools/bench_serving.py``).

A Poisson client submits ``--requests`` single-frame requests to a
``serve.MicroBatcher`` over a seeded ``InferenceSession`` at each offered
rate of ``--loads`` (requests/s), on a fixed schedule: the arrival times
are drawn before the run (exponential gaps from
``np.random.default_rng(seed)``) and each request goes in at its time,
whether or not the earlier ones are answered. Every request carries a
distinct image (the base frame plus its own uint8 noise). Per load:

* p50 / p99 / max client latency, submit to the future's result (the
  result is numpy on the host, so the device work is in it);
* the achieved requests/s (answered requests over the time from the first
  submit to the last answer) beside the arrival rate the schedule gave;
* the coalesced batch histogram and the padding overhead (padded slots /
  computed slots: the cost of rounding a batch up to its bucket);
* ``backlog_max``, the most requests outstanding at any submit, and
  ``saturated``: the server answered below 95% of the arrival rate, so the
  queue grew through the run. An open loop past the server's rate does not
  settle; the run still ends, because the schedule is finite: every future
  is awaited (300 s a load at most) and one unanswered exits 1.

    python -m cnmnet_tpu_torch.tools.bench_serving [--height 192 --width 256] [--views 3]
        [--loads 20,50,100,150] [--requests 200] [--max-wait-ms 3] [--buckets 1,4,8]
        [--outputs idepth,depth,prob,normal] [--wire-dtype float32] [--seed 0]
        [--device cuda] [dotted.overrides=...]

Prints one JSON object per load and a markdown table.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import threading
import time
from typing import Dict, Sequence

import numpy as np


def batch_histogram(sizes: Sequence[int]) -> Dict[int, int]:
    """Coalesced batch size -> how many batches had it."""
    out: Dict[int, int] = {}
    for n in sizes:
        out[int(n)] = out.get(int(n), 0) + 1
    return dict(sorted(out.items()))


def padding(sizes: Sequence[int], buckets: Sequence[int]):
    """``(padded slots, computed slots)``: each batch runs at the smallest
    bucket that holds it."""
    computed = [next(b for b in sorted(buckets) if n <= b) for n in sizes]
    return sum(c - n for c, n in zip(computed, sizes)), sum(computed)


class Counting:
    """The session, recording the size of every batch the batcher hands to
    ``predict_async``."""

    def __init__(self, inner):
        self._inner = inner
        self.sizes = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def predict_async(self, images, cams):
        self.sizes.append(images.shape[0])
        return self._inner.predict_async(images, cams)


def request_pool(base: np.ndarray, n: int, rng) -> np.ndarray:
    """``n`` distinct uint8 frames: ``base`` plus per-request noise in
    [-3, 3], clipped."""
    noise = rng.integers(-3, 4, (n,) + base.shape, dtype=np.int16)
    return np.clip(base.astype(np.int16)[None] + noise, 0, 255).astype(np.uint8)


def run_load(session, pool: np.ndarray, cams: np.ndarray, rate: float, rng, max_batch: int,
             max_wait_ms: float, timeout: float = 300.0) -> dict:
    """One open-loop run of ``len(pool)`` requests at ``rate`` requests/s."""
    from cnmnet_tpu_torch.serve import MicroBatcher

    n = len(pool)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    counting = Counting(session)
    mb = MicroBatcher(counting, max_batch=max_batch, max_wait_ms=max_wait_ms)
    submitted, answered = np.zeros(n), np.full(n, np.nan)
    lock = threading.Lock()
    done = [0]
    backlog = 0

    def on_done(i):
        def record(_):
            with lock:
                answered[i] = time.perf_counter()
                done[0] += 1
        return record

    futs = []
    try:
        t0 = time.perf_counter()
        for i in range(n):
            wait = t0 + arrivals[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            submitted[i] = time.perf_counter()
            with lock:
                backlog = max(backlog, i - done[0])
            fut = mb.submit(pool[i], cams)
            fut.add_done_callback(on_done(i))
            futs.append(fut)
        _, pending = concurrent.futures.wait(futs, timeout=timeout)
        for f in pending:
            f.cancel()
    finally:
        mb.close()
    failed = sum(1 for f in futs if f.done() and not f.cancelled() and f.exception() is not None)
    ok = ~np.isnan(answered)
    lat_ms = (answered[ok] - submitted[ok]) * 1e3
    span = (np.nanmax(answered) - submitted[0]) if ok.any() else float("nan")
    arrival_rps = (n - 1) / (submitted[-1] - submitted[0]) if n > 1 else float("nan")
    achieved = ok.sum() / span if ok.any() else 0.0
    padded, computed = padding(counting.sizes, session.buckets)
    return {
        "offered_rps": rate,
        "arrival_rps": arrival_rps,
        "achieved_rps": achieved,
        "p50_ms": float(np.percentile(lat_ms, 50)) if ok.any() else None,
        "p99_ms": float(np.percentile(lat_ms, 99)) if ok.any() else None,
        "max_ms": float(lat_ms.max()) if ok.any() else None,
        "mean_batch": float(np.mean(counting.sizes)) if counting.sizes else 0.0,
        "batches": len(counting.sizes),
        "batch_hist": batch_histogram(counting.sizes),
        "padding_overhead_pct": 100.0 * padded / max(computed, 1),
        "backlog_max": backlog,
        "saturated": bool(achieved < 0.95 * arrival_rps),
        "requests": n,
        "answered": int(ok.sum() - failed),
        "failed": failed,
        "unanswered": len(pending),
    }


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import device_name
    from cnmnet_tpu_torch.config import Config, apply_overrides
    from cnmnet_tpu_torch.data.pipeline import collate, quantize_images_u8
    from cnmnet_tpu_torch.data.synthetic import SyntheticScenes
    from cnmnet_tpu_torch.serve import InferenceSession

    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--views", type=int, default=3)
    ap.add_argument("--loads", default="20,50,100,150")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--max-wait-ms", type=float, default=3.0)
    ap.add_argument("--buckets", default="1,4,8")
    ap.add_argument("--outputs", default="idepth,depth,prob,normal",
                    help="comma list: which outputs ride the wire")
    ap.add_argument("--wire-dtype", default="float32",
                    choices=["float32", "float16", "bfloat16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", default=[])
    args = ap.parse_args(argv)

    cfg = apply_overrides(Config(), [f"dataset.image_height={args.height}",
                                     f"dataset.image_width={args.width}"] + args.overrides)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    session = InferenceSession(cfg, batch_buckets=buckets, outputs=tuple(args.outputs.split(",")),
                               wire_dtype=args.wire_dtype, device=args.device)
    print(f"device: {device_name(session.device)}; outputs={session.outputs} "
          f"wire={session.wire_dtype} buckets={session.buckets}", flush=True)

    ds = SyntheticScenes(num_samples=1, height=args.height, width=args.width,
                         view_num=args.views)
    base = collate([ds[0]])
    base_img = quantize_images_u8(base["images"])[0]  # [V, H, W, 3]
    cams = base["cams"].astype(np.float32)[0]
    rng = np.random.default_rng(args.seed)
    pool = request_pool(base_img, args.requests, rng)

    t0 = time.monotonic()
    session.warmup(args.views, args.height, args.width)
    print(f"warmup of buckets {session.buckets}: {time.monotonic() - t0:.2f} s", flush=True)

    rows = []
    for load in (float(x) for x in args.loads.split(",")):
        row = run_load(session, pool, cams, load, rng, max(buckets), args.max_wait_ms)
        rows.append(row)
        print(json.dumps(row), flush=True)

    print("\n| offered req/s | arrivals | achieved | p50 ms | p99 ms | mean batch | padding % "
          "| backlog max | saturated |\n|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        p50, p99 = ("-" if r[k] is None else f"{r[k]:.3f}" for k in ("p50_ms", "p99_ms"))
        print(f"| {r['offered_rps']:.2f} | {r['arrival_rps']:.2f} | {r['achieved_rps']:.2f} | "
              f"{p50} | {p99} | {r['mean_batch']:.2f} | "
              f"{r['padding_overhead_pct']:.1f} | {r['backlog_max']} | {r['saturated']} |")
    bad = [r for r in rows if r["unanswered"] or r["failed"]]
    if bad:
        print(f"FAIL: {sum(r['unanswered'] for r in bad)} requests unanswered and "
              f"{sum(r['failed'] for r in bad)} failed")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
