"""Experiment logging (``cnmnet_tpu/obs/logger.py``): a JSONL event stream
and PNG image dumps.

* scalars -> ``events.jsonl``, one JSON object per call: step, wall time,
  ``"type": "scalars"`` and the values;
* histograms -> seven summary statistics (min, max, mean, std, p5, p50,
  p95) of the finite values, in the same stream;
* images -> ``images/<tag>/<step:08d>.png``, written by the port's numpy
  codec (``data/imageio.write_png``; the card's machine has no PIL);
* the run's configuration -> ``config.json``.

Only the main process writes: rank 0 of an initialised
``torch.distributed`` process group, or the only process.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from cnmnet_tpu_torch.data.imageio import write_png


def _is_main_process() -> bool:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class MetricLogger:
    def __init__(self, log_dir: str, config: Optional[dict] = None, echo=print):
        self.log_dir = log_dir
        self.enabled = _is_main_process()
        self.echo = echo
        if not self.enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._events = open(os.path.join(log_dir, "events.jsonl"), "a", buffering=1)
        if config is not None:
            with open(os.path.join(log_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log_scalars(self, step: int, values: Dict[str, float], prefix: str = ""):
        if not self.enabled:
            return
        record = {"step": step, "time": time.time(), "type": "scalars"}
        record.update({k: float(v) for k, v in values.items()})
        self._events.write(json.dumps(record) + "\n")
        if self.echo:
            pretty = " ".join(f"{k}: {v:.4f}" for k, v in values.items() if isinstance(v, float))
            self.echo(f"[{prefix}][{step}] {pretty}")

    def log_histogram(self, step: int, tag: str, values):
        if not self.enabled:
            return
        v = np.asarray(values).ravel()
        v = v[np.isfinite(v)]
        if v.size == 0:
            return
        record = {
            "step": step,
            "time": time.time(),
            "type": "histogram",
            "tag": tag,
            "min": float(v.min()),
            "max": float(v.max()),
            "mean": float(v.mean()),
            "std": float(v.std()),
            "p5": float(np.percentile(v, 5)),
            "p50": float(np.percentile(v, 50)),
            "p95": float(np.percentile(v, 95)),
        }
        self._events.write(json.dumps(record) + "\n")

    def log_image(self, step: int, tag: str, image: np.ndarray):
        """image: [H, W, 3] uint8 (or float in [0, 1])."""
        if not self.enabled:
            return
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        d = os.path.join(self.log_dir, "images", tag)
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, f"{step:08d}.png"), np.ascontiguousarray(img))

    def close(self):
        if self.enabled:
            self._events.close()
