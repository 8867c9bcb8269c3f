"""What a ``--trace 1`` run reads besides the program's counters: the
device's busy time in the window and each kernel's device time by name
(``torch.profiler``, CUPTI), the shapes of each call into the two hand
kernels' entries (``kernels/dispatch``), and the breakdown the result line
carries.

Nothing here runs in a ``--trace 0`` run.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
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
    ("emcpy", "memory copies"),
    ("emset", "memory copies"),
    ("elementwise", "elementwise"),
    ("reduce", "reductions"),
    ("cat", "concatenations"),
)


def kernel_class(name: str) -> str:
    return next((c for frag, c in KERNEL_CLASSES if frag in name), "other")


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """``with DeviceTrace() as t:`` around the measured window; afterwards
    ``t.summary()`` gives ``busy_s``, ``window_s`` and the breakdown."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def summary(self, window_s: float) -> dict:
        """Busy seconds of the device (kernels, copies and sets, their union),
        the traced window, the device time by kernel class and the longest
        idle gaps, each named by the host operation that overlapped it most."""
        events = self._prof.profiler.kineto_results.events()
        device, host = [], []
        for e in events:
            if e.is_user_annotation():
                continue  # a host range mirrored on the device timeline, no device work
            span = (e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((span, e.name()))
            else:
                host.append((span, e.name()))
        busy = _merge([s for s, _ in device])
        by_class: Dict[str, float] = {}
        by_name: Dict[str, float] = {}
        for (a, b), name in device:
            cls = kernel_class(name)
            by_class[cls] = by_class.get(cls, 0.0) + (b - a) / 1e9
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        gaps = sorted(((b2[0] - b1[1], b1[1], b2[0]) for b1, b2 in zip(busy, busy[1:])),
                      reverse=True)[:10]
        starts = np.array([h[0][0] for h in host], np.int64)
        ends = np.array([h[0][1] for h in host], np.int64)
        named = []
        for length, a, b in gaps:
            overlap = np.minimum(ends, b) - np.maximum(starts, a)
            i = int(overlap.argmax()) if len(overlap) else -1
            best = host[i][1] if i >= 0 and overlap[i] > 0 else "no host operation"
            named.append([best, length / 1e9])
        busy_s = sum(b - a for a, b in busy) / 1e9
        return {
            "busy_s": busy_s,
            "window_s": window_s,
            "device_kernels": by_name,
            "breakdown": {
                "device_ops": sorted(([k, v] for k, v in by_class.items()),
                                     key=lambda kv: -kv[1])[:10],
                "idle_gaps": named,
            },
        }


class KernelCalls:
    """The shape of every call of ``kernels/dispatch.cost_volume`` and
    ``dispatch.depth_to_normal`` while active, as ``counts.kernel_cost``
    takes it, with its output's bytes per element. The program looks both
    entries up on the module at each call, so wrapping the module's
    attributes sees every call."""

    def __init__(self):
        self.calls: Dict[str, list] = {"cost_volume": [], "depth_to_normal": []}
        self._stack = contextlib.ExitStack()

    def _wrap(self, dispatch, name, shape_of):
        inner = getattr(dispatch, name)

        def counted(*args, **kwargs):
            out = inner(*args, **kwargs)
            self.calls[name].append(shape_of(out, *args, **kwargs))
            return out

        setattr(dispatch, name, counted)
        self._stack.callback(setattr, dispatch, name, inner)

    def __enter__(self):
        from cnmnet_tpu_torch.kernels import dispatch

        def cv_shape(out, *args, **kwargs):
            return tuple(out.shape), out.element_size()  # [pairs, H, W, planes]

        def d2n_shape(normals, depth, intrinsics_inv, k_size=9, *args, **kwargs):
            return tuple(depth.shape) + (int(k_size),), 4

        self._wrap(dispatch, "cost_volume", cv_shape)
        self._wrap(dispatch, "depth_to_normal", d2n_shape)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

