"""Timing and averaging (``cnmnet_tpu/obs/meters.py``) with device
synchronisation, and ``profile_trace`` over ``torch.profiler``.

``AverageMeter`` is the reference's running average. ``StepTimer`` times a
block or a call on the host clock and, before it reads the clock, waits for
the device that holds the result: ``torch.cuda.synchronize(device)`` for a
CUDA tensor (PyTorch returns before the card finishes), nothing for a CPU
tensor. A result may be a tensor or a tuple, list or dict of them.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of ``result``."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            synchronize(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            synchronize(v)


class StepTimer:
    """Wall-clock timing of device work with explicit sync."""

    def __init__(self):
        self.meter = AverageMeter()

    @contextlib.contextmanager
    def measure(self, result_ref=None):
        """Time the block; ``result_ref`` (a tensor, or a list the block
        fills) is synchronised before the clock stops."""
        t0 = time.monotonic()
        yield
        if result_ref is not None:
            synchronize(result_ref)
        self.meter.update(time.monotonic() - t0)

    def timed(self, fn, *args, **kwargs):
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        synchronize(out)
        self.meter.update(time.monotonic() - t0)
        return out

    @property
    def mean(self):
        return self.meter.avg


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the block with ``torch.profiler`` (host, and the card when
    there is one) and write a Chrome trace to ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
