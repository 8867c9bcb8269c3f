"""Seeded synthetic inputs for the tools (``__graft_entry__.py:_tiny_batch``)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cnmnet_tpu_torch.data.pipeline import collate, normalize_images
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes
from cnmnet_tpu_torch.serve import resolve_device


def tiny_batch(batch_size: int, height: int = 32, width: int = 64, views: int = 3,
               device="cuda") -> Dict[str, torch.Tensor]:
    """``batch_size`` collated ``SyntheticScenes`` samples (seed 0) with
    normalised images and no ``index``, as tensors on ``device``."""
    dev = resolve_device(device)
    ds = SyntheticScenes(num_samples=batch_size, height=height, width=width, view_num=views)
    batch = collate([ds[i] for i in range(batch_size)])
    batch["images"] = normalize_images(batch["images"])
    batch.pop("index", None)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
