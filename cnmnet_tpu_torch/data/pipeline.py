"""Host-side batch helpers (from ``cnmnet_tpu/data/pipeline.py``), numpy only.

The threaded ``PrefetchLoader`` comes with the training slice.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize_images(images: np.ndarray) -> np.ndarray:
    """ImageNet zero-mean/unit-var on [0, 1] RGB."""
    return ((images - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def quantize_images_u8(images: np.ndarray) -> np.ndarray:
    """[0, 1] float RGB -> the uint8 wire format; the inverse affine runs on
    the device (``ops/images.prepare_images``)."""
    return np.clip(np.rint(images * 255.0), 0, 255).astype(np.uint8)


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into one batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in keys}
