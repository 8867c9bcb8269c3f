"""The program's spans and counters on the device trace's timeline: a run of
one serving cell with the span recorder (``cnmnet_tpu_torch/obs/spans.py``)
on, the readers of the metrics taken from it, and the device's idle time
put down to what the batcher's thread was doing.

    python3 -m benchmark.spans --workload serve-3v-open --seed <n> --seconds <s> \
        [--profile 0|1] [--record 0|1]

runs the cell as ``run.py --trace 1`` does (the same traffic, window, proxy
of the session and, with ``--profile 1``, the same device trace and kernel
recorder), with the recorder on from the window's start to the end of its
trace unless ``--record 0``. It prints one JSON object: ``correct``, every
metric of the cell, end-to-end and per-layer (those that need the device
trace are absent with ``--profile 0``), the span metrics (the readers
``metrics/{queue_wait_ms,stage_ms,launch_ms,device_wait_ms,pad_pct,
idle_dispatch_pct}.py``), and ``spans``: the mean of each span, the idle
time by the innermost span open on the batcher's thread, and the p95
requests broken down (``breakdown``). With ``--record 0 --profile 0`` it
is the run with neither, for the recorder's cost.

The readings it adds to the traffic's own are those the readers take:
``spans`` (the recorder's spans, ``time.perf_counter_ns`` stamps),
``span_offset_ns`` (onto the profiler's clock), ``device_busy_ns`` (the
device's busy intervals, merged, on the profiler's clock), and
``frames_real`` / ``frames_run`` (the session's counters, their change
across the window).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from typing import Dict, List, Sequence

import numpy as np

from benchmark import run

QUEUE = "serve.batcher.queue"
BATCH = "serve.batcher.dispatch"
DELIVER = "serve.batcher.deliver"
# what a request's batch waits through between its dispatch and its delivery
WAITED_THROUGH = (("next_collect", "serve.batcher.collect"), ("next_dispatch", BATCH),
                  ("device_wait", "serve.session.device_wait"),
                  ("unpack", "serve.session.unpack"), ("other_deliveries", DELIVER))
STEMS = ("queue_wait_ms", "stage_ms", "launch_ms", "device_wait_ms", "pad_pct", "idle_dispatch_pct")


# -- the arithmetic the readers share -----------------------------------------

def busy_intervals(trace) -> np.ndarray:
    """The device's busy intervals of a ``trace.DeviceTrace`` after its exit,
    merged, ``[n, 2]`` int64 ns on the profiler's clock: the same events
    as its ``summary``'s ``busy_s``."""
    import torch

    from benchmark.trace import _merge

    events = trace._prof.profiler.kineto_results.events()
    device = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
              if not e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CUDA]
    return np.asarray(_merge(device), np.int64).reshape(-1, 2)


def covered_before(intervals: np.ndarray, t) -> np.ndarray:
    """ns covered by the sorted, disjoint ``[n, 2]`` ``intervals`` before each
    time in ``t``."""
    t = np.asarray(t, np.int64)
    if not len(intervals):
        return np.zeros(t.shape, np.int64)
    starts, ends = intervals[:, 0], intervals[:, 1]
    done = np.concatenate([[0], np.cumsum(ends - starts)])
    j = np.searchsorted(starts, t, side="right") - 1
    k = np.maximum(j, 0)
    return np.where(j >= 0, done[k] + np.minimum(t, ends[k]) - starts[k], 0)


def idle_inside(busy: np.ndarray, a, b) -> np.ndarray:
    """Idle ns of the device (merged busy intervals ``busy``) inside each
    interval ``[a, b)``."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    return (b - a) - (covered_before(busy, b) - covered_before(busy, a))


def named(spans: Sequence, name: str) -> list:
    return [s for s in spans if s.name == name]


def durations_ms(spans: Sequence, name: str) -> np.ndarray:
    return np.asarray([(s.end_ns - s.start_ns) / 1e6 for s in named(spans, name)])


def mean_ms(r, name: str):
    """The mean ms of the readings' spans named ``name``; None without one."""
    ms = durations_ms(r.get("spans") or (), name)
    return float(ms.mean()) if len(ms) else None


def innermost(spans: Sequence) -> List[tuple]:
    """``[(start, end, name)]``: the time of properly nested spans (one
    thread's), each moment under the innermost span open then."""
    segments, stack, cursor = [], [], None

    def close_until(t):
        nonlocal cursor
        while stack and stack[-1].end_ns <= t:
            top = stack.pop()
            segments.append((cursor, top.end_ns, top.name))
            cursor = top.end_ns

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        close_until(s.start_ns)
        if stack and cursor < s.start_ns:
            segments.append((cursor, s.start_ns, stack[-1].name))
        stack.append(s)
        cursor = s.start_ns
    close_until(np.iinfo(np.int64).max)
    return [seg for seg in segments if seg[1] > seg[0]]


def batcher_thread(spans: Sequence):
    batches = named(spans, BATCH)
    return batches[0].thread if batches else None


def idle_by_span(r) -> Dict[str, float]:
    """Idle seconds of the traced window by the innermost span open on the
    batcher's thread at that moment; ``(none)`` for the rest."""
    spans, busy, offset = r["spans"], r["device_busy_ns"], r["span_offset_ns"]
    thread = batcher_thread(spans)
    own = [s for s in spans if s.thread == thread and s.name != QUEUE]
    segments = innermost(own)
    out: Dict[str, float] = {}
    if segments:
        a, b, names = zip(*segments)
        idle = idle_inside(busy, np.asarray(a) + offset, np.asarray(b) + offset)
        for name, ns in zip(names, idle.tolist()):
            out[name] = out.get(name, 0.0) + ns / 1e9
    out["(none)"] = r["trace_window_s"] - r["busy_s"] - sum(out.values())
    return out


def breakdown(spans: Sequence, share: float = 0.95) -> Dict[str, float]:
    """Mean ms of each part of the requests at or above the ``share``
    quantile of submit -> delivered: the queue, their own batch's dispatch,
    then what the batcher's thread did until their delivery began (the
    next batch's collect and dispatch, device waits and unpacks, other
    chunks' deliveries), their delivery, and the rest."""
    queue = {s.id: s for s in named(spans, QUEUE)}
    own = {rid: s for s in named(spans, BATCH) for rid in s.attrs["requests"]}
    delivered = {rid: s for s in named(spans, DELIVER) for rid in s.attrs["requests"]}
    rids = [rid for rid in queue if rid in own and rid in delivered]
    if not rids:
        return {}
    q, d, v = (np.asarray([(m[rid].start_ns, m[rid].end_ns) for rid in rids], np.int64)
               for m in (queue, own, delivered))
    total = v[:, 1] - q[:, 0]
    parts = {"queue": q[:, 1] - q[:, 0], "own_dispatch": d[:, 1] - d[:, 0]}
    thread = batcher_thread(spans)
    for label, name in WAITED_THROUGH:
        intervals = np.asarray(sorted((s.start_ns, s.end_ns) for s in named(spans, name)
                                      if s.thread == thread), np.int64).reshape(-1, 2)
        parts[label] = covered_before(intervals, v[:, 0]) - covered_before(intervals, d[:, 1])
    parts["deliver"] = v[:, 1] - v[:, 0]
    parts["rest"] = total - sum(parts.values())
    parts["total"] = total
    top = total >= np.quantile(total, share)
    out = {k: float(x[top].mean()) / 1e6 for k, x in parts.items()}
    out["requests"] = int(top.sum())
    return out


# -- the run -------------------------------------------------------------------

class SpanContext(run.Context):
    """``run.Context`` with ``trace`` on (the open loop's proxy and the
    per-layer readings), the device trace only with ``profile``, and the
    recorder on with ``record``."""

    def __init__(self, *args, profile: bool, record: bool):
        super().__init__(*args)
        self.profile, self.record, self.session = profile, record, None

    def window(self):
        return SpanWindow(self)


def _frames(session):
    return getattr(session, "frames_real", None), getattr(session, "frames_run", None)


class SpanWindow(run.Window):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.taken = None

    def __enter__(self):
        from cnmnet_tpu_torch.obs import spans

        self.frames0 = _frames(self.ctx.session)
        trace, self.ctx.trace = self.ctx.trace, self.ctx.profile
        try:
            super().__enter__()
        finally:
            self.ctx.trace = trace
        if self.ctx.record:
            spans.enable()
        return self

    def end_trace(self) -> None:
        from cnmnet_tpu_torch.obs import spans

        if self.taken is None:
            super().end_trace()
            self.taken = spans.take()
            spans.disable()
            self.frames1 = _frames(self.ctx.session)

    def readings(self) -> dict:
        out = {"spans": self.taken.spans, "span_offset_ns": self.taken.offset_ns}
        if None not in self.frames0:
            out["frames_real"] = self.frames1[0] - self.frames0[0]
            out["frames_run"] = self.frames1[1] - self.frames0[1]
        if self.trace is not None:
            summary = self.trace.summary(self.traced)
            out.update(busy_s=summary["busy_s"], trace_window_s=summary["window_s"],
                       device_kernels=summary["device_kernels"], kernel_calls=self.kernels.calls,
                       device_busy_ns=busy_intervals(self.trace))
        return out


def run_spans(spec: run.Spec, seed: int, seconds: float, profile: bool, record: bool,
              device: str = "cuda") -> dict:
    """One run of the cell ``spec``; returns the object ``main`` prints."""
    import torch

    from benchmark import check

    ctx = SpanContext(spec, seed, seconds, True, device, run.T_START, profile=profile,
                      record=record)
    traffic = importlib.import_module(f"benchmark.drivers.{spec.traffic['driver']}")
    ctx.session, state = traffic.build(ctx)
    readings = traffic.measure(ctx, ctx.session, state)
    (window,) = ctx.windows
    window.end_trace()
    readings.update(setup_s=ctx.setup_s, window_s=seconds, **window.readings())
    correct, checks = check.judge(readings.pop("check"), spec.config, spec.limits)
    suffix = spec.cell["name"].rsplit("-", 1)[-1]
    metrics = {}
    for name in [m["name"] for m in spec.metrics] + [f"{stem}.{suffix}" for stem in STEMS]:
        value = run.reader(name)(readings)
        if value is not None:
            metrics[name] = float(value)
    taken = readings["spans"]
    means = {name: float(durations_ms(taken, name).mean())
             for name in sorted({s.name for s in taken})}
    out = {"correct": bool(correct and readings["failed"] == 0), "profile": profile,
           "record": record, "metrics": metrics, "spans": {"mean_ms": means,
                                                           "breakdown": breakdown(taken)},
           "device": torch.cuda.get_device_name(0) if torch.device(device).type == "cuda"
           else "cpu"}
    if "device_busy_ns" in readings and taken:
        out["spans"]["idle_s"] = idle_by_span(readings)
    out["checks"] = {k: v["value"] for k, v in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this measures the card", file=sys.stderr)
        return 2
    t = time.perf_counter()
    result = run_spans(run.load_spec(args.workload), args.seed, args.seconds, bool(args.profile),
                       bool(args.record))
    print(f"run took {time.perf_counter() - t:.1f} s", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
