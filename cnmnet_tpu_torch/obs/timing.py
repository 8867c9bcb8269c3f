"""Device time of a forward by the chain-slope method
(``cnmnet_tpu/obs/timing.py``).

Each call's input depends on the previous call's output (a 1e-30-scaled
sum folded into the images: numerically nothing, but it orders the calls
and makes every input distinct), the chain ends with a value fetch (the
whole chain ran), and the per-call time is the slope between a short and a
long chain, which cancels the fixed costs of launch and fetch. On CUDA the
dependent chain keeps the asynchronous launches honest: the fetch waits
for every call. ``chip_smoke.py`` prints it beside a CUDA-event time of the
same forward.
"""

from __future__ import annotations

import statistics
import time

import torch


def forward_slope_seconds(forward, images, cams, k1: int = 8, k2: int = 32, repeats: int = 3):
    """Per-call seconds of ``forward(images, cams) -> out`` (``out`` may be a
    tuple; its first element is the dependency probe): the median of
    ``repeats`` slopes ``(t(k2) - t(k1)) / (k2 - k1)``."""

    def first(out):
        return out[0] if isinstance(out, (tuple, list)) else out

    def mix(imgs, probe):
        return imgs + (1e-30 * probe.float().sum()).to(imgs.dtype)

    def chain(k):
        imgs = images
        t0 = time.monotonic()
        out = None
        for _ in range(k):
            out = forward(imgs, cams)
            imgs = mix(imgs, first(out))
        float(first(out).float().sum())  # the value fetch: the chain really ran
        return time.monotonic() - t0

    with torch.inference_mode():
        chain(2)  # first-call costs
        slopes = []
        for _ in range(max(1, repeats)):
            t1, t2 = chain(k1), chain(k2)
            slopes.append((t2 - t1) / (k2 - k1))
    return statistics.median(slopes)
