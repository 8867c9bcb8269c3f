"""Checkpoint and resume with ``torch.save`` (``cnmnet_tpu/train/checkpoint.py``).

One checkpoint is ``<directory>/<step>/state.pt``: the model's
``state_dict`` (parameters and BatchNorm statistics), the optimizer state
(step count and moments, by parameter name), and the step and epoch. The
manager keeps the JAX manager's contract:

* ``save(state, step)`` writes the step once; saving a step that exists
  does nothing (an interval save and an epoch-end save can meet);
* the write is atomic: the file goes into a temporary directory that
  ``os.replace`` renames to ``<step>``, so a reader sees a whole checkpoint
  or none;
* the newest ``max_to_keep`` steps are kept;
* ``restore(x, template, with_optimizer=True)`` takes an int step of this
  manager, ``None`` or ``"latest"``, another manager's root (its newest
  step), or a step directory; ``with_optimizer=False`` restores the
  weights and counters and starts the moments from zero, as the reference
  does on resume.

Saving is synchronous; ``wait()`` exists for the contract and returns at
once. Loading uses ``torch.load(weights_only=True)``: a checkpoint holds
tensors, numbers and dicts only.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from cnmnet_tpu_torch.serve import resolve_device
from cnmnet_tpu_torch.train.state import TrainState

FILE = "state.pt"


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.isfile(os.path.join(directory, d, FILE)))


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 8, device="cuda"):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.device = resolve_device(device)
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self):
        return _steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: Optional[int] = None) -> int:
        step = state.step if step is None else int(step)
        final = os.path.join(self.directory, str(step))
        if os.path.isdir(final):
            return step
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({
            "model": state.model.state_dict(),
            "opt_state": state.opt_state,
            "step": int(state.step),
            "epoch": int(state.epoch),
        }, os.path.join(tmp, FILE))
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        return step

    def wait(self):
        pass

    def _path(self, directory_or_step) -> Optional[str]:
        if isinstance(directory_or_step, int):
            return os.path.join(self.directory, str(directory_or_step), FILE)
        if directory_or_step in (None, "latest"):
            step = self.latest_step()
            return None if step is None else os.path.join(self.directory, str(step), FILE)
        path = os.path.abspath(str(directory_or_step))
        steps = _steps(path)
        if steps:  # a manager root: its newest step
            return os.path.join(path, str(steps[-1]), FILE)
        return os.path.join(path, FILE)  # a step directory

    def restore(self, directory_or_step, template: TrainState,
                with_optimizer: bool = True) -> Optional[TrainState]:
        """Load a checkpoint into ``template``'s model (in place) and return
        a state with it; ``None`` when ``"latest"`` finds no step."""
        path = self._path(directory_or_step)
        if path is None:
            return None
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        template.model.load_state_dict(ckpt["model"])
        if with_optimizer:
            opt_state = ckpt["opt_state"]
        else:
            opt_state = {k: ({n: torch.zeros_like(t) for n, t in v.items()}
                             if isinstance(v, dict) else 0)
                         for k, v in template.opt_state.items()}
        return TrainState(model=template.model, opt_state=opt_state,
                          step=ckpt["step"], epoch=ckpt["epoch"])
