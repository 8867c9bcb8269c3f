"""Image normalisation for the uint8 wire (``cnmnet_tpu/ops/images.py``).

A uint8 batch gets the ImageNet affine ``(x/255 - mean)/std`` as one
``x * scale + shift`` on the device; a float batch (already normalised on
the host by ``data/pipeline.normalize_images``) passes through.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cnmnet_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD

_SCALE = (1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
_SHIFT = (-IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _affine(device: torch.device):
    """(scale, shift) on ``device``, copied there once per process."""
    return torch.from_numpy(_SCALE).to(device), torch.from_numpy(_SHIFT).to(device)


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., 3]`` RGB -> normalised float32; float passthrough."""
    if images.dtype == torch.uint8:
        scale, shift = _affine(images.device)
        return images.float() * scale + shift
    return images
