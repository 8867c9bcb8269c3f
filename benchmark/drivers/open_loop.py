"""Open-loop serving: single-frame requests on a fixed schedule through
``serve.MicroBatcher`` over an ``InferenceSession``.

The schedule is drawn before the run. Its gaps are exponential (Poisson
arrivals at the traffic's ``rate_rps``), and there are exactly ``rate x
seconds`` of them, scaled to fill the window: every seed gets the same set
of gaps, in an order of its own, so seeds change which request comes when
and not how much work there is. Requests cycle through ``distinct``
frames (``inputs.request_pool``): any ``distinct`` requests in a row, and so
every batch, are distinct frames. Set-up ends with the same traffic
for ``warmup_s`` seconds, untimed. A request is timed from when it was due,
not from when the generator got to it, so a stall counts against every request
it delays; the generator's own lateness is reported beside.

After the window every request due in it is awaited, a minute past the
close at most; one that never comes or fails counts as missing every
limit. A sample of the answered requests, drawn from the seed, is kept
for the comparison with the reference.

Copied from ``cnmnet_tpu_torch/tools/bench_serving.py:run_load`` with that
one change (its times ran from the actual submit).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import threading
import time

import numpy as np
import torch

from benchmark import counts, inputs

DRAIN_S = 60.0


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in ``[0, seconds)``: ``round(rate x seconds)`` exponential
    gaps from a fixed draw, scaled to sum to ``seconds``, in an order drawn
    from ``seed``."""
    n = max(int(round(rate * seconds)), 1)
    gaps = np.random.default_rng(0).exponential(1.0, n)
    gaps = gaps[np.random.default_rng(int(seed)).permutation(n)] * (seconds / gaps.sum())
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


class Proxy:
    """The session as the batcher sees it, with the host time of each
    ``predict_async`` recorded and the two calls named in the trace."""

    def __init__(self, inner):
        self._inner = inner
        self.dispatch_s = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def predict_async(self, images, cams):
        with torch.profiler.record_function("session.predict_async"):
            t = time.perf_counter()
            handle = self._inner.predict_async(images, cams)
            self.dispatch_s.append(time.perf_counter() - t)
        return handle

    def fetch(self, handle):
        with torch.profiler.record_function("session.fetch"):
            return self._inner.fetch(handle)


def build(ctx):
    """The session and the batcher of the cell, weights loaded and every
    bucket warmed for the cell's one signature."""
    from cnmnet_tpu_torch.config import Config, apply_overrides
    from cnmnet_tpu_torch.serve import InferenceSession

    m, t = ctx.config["model"], ctx.traffic
    H, W = ctx.config["image_height"], ctx.config["image_width"]
    cfg = apply_overrides(Config(), [f"dataset.image_height={H}", f"dataset.image_width={W}",
                                     f"model.idepth_scale={m['idepth_scale']}",
                                     f"model.num_planes={m['num_planes']}",
                                     f"model.k_size={m['k_size']}"])
    dtype = getattr(torch, ctx.config["serve_dtype"])
    state = inputs.make_state(m["num_planes"], ctx.seed, ctx.device, dtype)
    session = InferenceSession(cfg, state_dict=state, batch_buckets=tuple(t["buckets"]),
                               outputs=tuple(t["outputs"]), wire_dtype=t["wire_dtype"],
                               compute_dtype=ctx.config["serve_dtype"], device=ctx.device)
    ctx.mark("session")
    session.warmup(ctx.views, H, W)
    ctx.mark("bucket warm-up")
    return session, state


def run(ctx) -> dict:
    return measure(ctx, *build(ctx))


def measure(ctx, session, state) -> dict:
    """One window of the traffic's schedule against a built ``session``."""
    from cnmnet_tpu_torch.serve import MicroBatcher

    t = ctx.traffic
    H, W = ctx.config["image_height"], ctx.config["image_width"]
    due = schedule(float(t["rate_rps"]), ctx.seconds, ctx.seed)
    n = len(due)
    distinct = min(n, int(t["distinct"]))
    images, cams = inputs.request_pool(distinct, int(t["scenes"]), H, W, ctx.config["sources"],
                                       ctx.seed, ctx.device)
    ctx.mark("request pool")
    proxy = Proxy(session) if ctx.trace else session
    mb = MicroBatcher(proxy, max_batch=int(t["max_batch"]), max_wait_ms=float(t["max_wait_ms"]))
    # set-up's last step: the traffic itself for a moment, so that the batcher's
    # thread, the pinned host buffers and every batch size it coalesces are warm
    warm = schedule(float(t["rate_rps"]), float(t["warmup_s"]), ctx.seed)
    start = time.perf_counter()
    pending = []
    for i, d in enumerate(warm):
        time.sleep(max(start + d - time.perf_counter(), 0.0))
        pending.append(mb.submit(images[i % distinct], cams[i % distinct]))
    concurrent.futures.wait(pending, timeout=DRAIN_S)  # what fails here fails in the window too
    ctx.mark("traffic warm-up")
    keep = set(np.random.default_rng(int(ctx.seed) + 1).choice(n, min(n, int(t["checked"])),
                                                                replace=False).tolist())
    answered = np.full(n, np.nan)
    results = {}
    lock = threading.Lock()

    def on_done(i):
        def record(fut):
            now = time.perf_counter()
            if fut.cancelled() or fut.exception() is not None:
                return
            with lock:
                answered[i] = now
                if i in keep:
                    results[i] = fut.result()
        return record

    futs, late = [], np.zeros(n)
    window = ctx.window()
    try:
        with window:
            served0, dispatched0 = mb.served, mb.dispatched
            calls0 = len(getattr(proxy, "dispatch_s", []))
            t0 = window.t0
            for i in range(n):
                wait = t0 + due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                late[i] = time.perf_counter() - (t0 + due[i])
                fut = mb.submit(images[i % distinct], cams[i % distinct])
                fut.add_done_callback(on_done(i))
                futs.append(fut)
            rest = t0 + ctx.seconds - time.perf_counter()
            if rest > 0:
                time.sleep(rest)
            served, dispatched = mb.served - served0, mb.dispatched - dispatched0
            calls = list(getattr(proxy, "dispatch_s", []))[calls0:]
        end = t0 + ctx.seconds
        deadline = end + DRAIN_S
        for fut in futs:
            with contextlib.suppress(Exception):
                fut.result(timeout=max(deadline - time.perf_counter(), 0.0))
        window.end_trace()  # drained: the batcher's thread launches nothing now
    finally:
        with contextlib.suppress(RuntimeError):  # a batcher still stuck: its requests count as failed
            mb.close(timeout=DRAIN_S)
    gave_up = time.perf_counter()
    with lock:
        done = answered.copy()
    ok = ~np.isnan(done)
    latency = np.where(ok, done - (t0 + due), gave_up - (t0 + due)) * 1e3
    sample = sorted(results)
    out = {k: np.stack([results[i][k] for i in sample]) for k in t["outputs"]} if sample else {}
    in_window = int((ok & (done <= end)).sum())
    request_flops = counts.forward_flops(ctx.config["model"], H, W, ctx.views,
                                         normals="normal" in t["outputs"])
    return {
        "attempted": n,
        "failed": int((~ok).sum()),
        "due_latency_ms": latency,
        "answered_in_window": in_window,
        "answered": int(ok.sum()),
        "request_flops": request_flops,
        "work_flops": in_window * request_flops,
        "peak_flops": counts.PEAK_FLOPS[ctx.config["serve_peak"]],
        "served": served,
        "dispatched": dispatched,
        "dispatch_host_ms": [s * 1e3 for s in calls],
        "generator_late_ms": float(late.max() * 1e3),
        "check": {"images": images[np.asarray(sample, np.int64) % distinct],
                  "cams": cams[np.asarray(sample, np.int64) % distinct], "outputs": out,
                  "state": state},
    }
