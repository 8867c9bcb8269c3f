"""Averaging (``cnmnet_tpu/obs/meters.py``) and device synchronisation.

``AverageMeter`` is the reference's running average. ``synchronize(result)``
waits for the device that holds a result before a host clock is read:
``torch.cuda.synchronize(device)`` for a CUDA tensor (PyTorch returns
before the card finishes), nothing for a CPU tensor. A result may be a
tensor or a tuple, list or dict of them.
"""

from __future__ import annotations

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
