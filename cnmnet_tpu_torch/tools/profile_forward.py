"""Device profile of bench's forward: the top device ops by total time
(``tools/profile_forward.py``).

Traces ``--iters`` calls of ``cnmnet_tpu_torch/bench.py``'s forward with
``torch.profiler`` (CPU and CUDA activity) after one untraced call, and
prints the device time per iteration of each kernel, its launches per
iteration, the device's busy time against the traced wall, and the time by
kernel class (``KERNEL_CLASSES``). The hand kernels show under their
``.so`` symbols (``cost_volume_kernel``, ``pack_source_kernel``,
``depth_to_normal_kernel``); ``KERNEL_CLASSES`` maps them. On the CPU there
is no device: the top host ops by self time are printed instead, as host
time.

This module holds the one classifier of kernel names into classes
(``kernel_class``) and ``profile_call``, which ``chip_smoke.py`` and
``profile_train`` use too.

    python -m cnmnet_tpu_torch.tools.profile_forward [--batch 1] [--iters 10] [--top 25]
        [--height 192 --width 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

# kernel name fragment -> class, first match wins
KERNEL_CLASSES = (
    ("cost_volume_kernel", "cost volume"),
    ("pack_source_kernel", "cost volume"),
    ("depth_to_normal_kernel", "depth->normal"),
    ("nchwToNhwc", "layout transposes"),
    ("nhwcToNchw", "layout transposes"),
    ("upsample", "upsampling"),
    ("batch_norm", "batch norm"),
    ("bn_fw", "batch norm"),
    ("xmma", "convolutions"),
    ("cutlass", "convolutions"),
    ("conv", "convolutions"),
    ("gemm", "convolutions"),
)
# backward kernel classes first: first match wins
TRAIN_KERNEL_CLASSES = (
    ("dgrad", "convolution dgrad"),
    ("wgrad", "convolution wgrad"),
    ("upsample_bilinear2d_backward", "upsampling backward"),
    ("batch_norm_backward", "batch norm backward"),
) + KERNEL_CLASSES
# ranges, not kernels: the plain depth->normal backward's record_function
RANGES = ("depth_to_normal_backward",)


def kernel_class(key: str, classes=KERNEL_CLASSES) -> str:
    return next((c for frag, c in classes if frag in key), "other")


def device_rows(prof):
    """``(name, ms, count)`` of every kernel with device time, largest first."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in RANGES]
    rows.sort(key=lambda r: -r[1])
    return rows


def by_class(rows, classes=KERNEL_CLASSES):
    out = {}
    for key, ms, _ in rows:
        cls = kernel_class(key, classes)
        out[cls] = out.get(cls, 0.0) + ms
    return out


def trace(call, iters: int, device: torch.device):
    """``iters`` traced calls after one untraced: ``(wall ms, profiler)``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    call()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            call()
        sync()
        wall_ms = (time.perf_counter() - t) * 1e3
    return wall_ms, prof


def profile_call(call, classes=KERNEL_CLASSES):
    """One traced ``call()`` on the card (``trace``): its host wall ms under
    the profiler, the device's busy ms (the sum of kernel times; one
    stream, so kernels do not overlap), ms by kernel class, and ``(name,
    ms, count)`` per kernel."""
    wall_ms, prof = trace(call, 1, torch.device("cuda"))
    rows = device_rows(prof)
    return wall_ms, sum(r[1] for r in rows), by_class(rows, classes), rows


def report(prof, wall_ms: float, iters: int, top: int, device: torch.device,
           classes=KERNEL_CLASSES) -> dict:
    """Print the top ops and the classes per iteration; returns the
    summary that is also printed as JSON."""
    if device.type == "cuda":
        rows = device_rows(prof)
        what = "device"
    else:
        rows = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.self_cpu_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        what = "host (no device)"
    busy = sum(r[1] for r in rows) / iters
    wall = wall_ms / iters
    print(f"{'us/iter':>10} {'calls':>6}  op   ({what} total {busy * 1e3:.1f} us/iter, traced "
          f"wall {wall * 1e3:.1f} us/iter)")
    for key, ms, n in rows[:top]:
        print(f"{ms / iters * 1e3:10.1f} {n / iters:6.1f}  {key[:110]}")
    summary = {"wall_ms": wall, "busy_ms": busy, "what": what,
               "top": [[key, ms / iters, n / iters] for key, ms, n in rows[:top]]}
    if device.type == "cuda":
        classes_ms = {c: ms / iters for c, ms in by_class(rows, classes).items()}
        summary["idle_share"] = 1 - busy / wall if wall > 0 else None
        summary["classes_ms"] = classes_ms
        print("by class: " + ", ".join(f"{c} {ms:.4f} ms" for c, ms in
                                       sorted(classes_ms.items(), key=lambda x: -x[1])))
        print(f"device busy {busy:.4f} ms of {wall:.4f} ms per iteration: idle share "
              f"{summary['idle_share']:.3f}")
    return summary


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import build_model, device_name, make_forward
    from cnmnet_tpu_torch.serve import resolve_device
    from cnmnet_tpu_torch.tools._batch import tiny_batch

    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    batch = tiny_batch(args.batch, args.height, args.width, device=device)
    forward = make_forward(build_model(device))
    print(f"device: {device_name(device)}; bench's forward, batch {args.batch}, "
          f"{args.height}x{args.width}, {args.iters} traced calls")
    wall_ms, prof = trace(lambda: forward(batch["images"], batch["cams"]), args.iters, device)
    summary = report(prof, wall_ms, args.iters, args.top, device)
    print(json.dumps({"batch": args.batch, **summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
