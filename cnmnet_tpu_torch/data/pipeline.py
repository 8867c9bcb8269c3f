"""Host-side input pipeline (``cnmnet_tpu/data/pipeline.py``): collation,
normalisation and the threaded ``PrefetchLoader``, numpy and threads only.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

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


def denormalize_images(images: np.ndarray) -> np.ndarray:
    """Back to [0, 1] RGB for visualization, from either wire format."""
    if images.dtype == np.uint8:
        return images.astype(np.float32) / 255.0
    return images * IMAGENET_STD + IMAGENET_MEAN


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into one batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in keys}


class PrefetchLoader:
    """Threaded map-style loader: indexes -> samples -> collated batches.

    ``dataset`` is anything with ``__len__`` and ``__getitem__`` -> a dict of
    arrays. Each epoch shuffles ``range(len(dataset))`` with
    ``np.random.default_rng(seed + epoch)`` (epochs count from 1), keeps
    the strided shard ``order[shard_index::shard_count]`` cut to the common
    length ``len(dataset) // shard_count`` (every shard yields the same
    number of batches), and splits it into ``batch_size`` batches, the last
    short one dropped under ``drop_last``. A producer thread maps each
    batch's samples over ``num_workers`` threads and keeps up to
    ``prefetch`` collated batches ready; a worker's exception is raised in
    the consumer.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        transform: Optional[Callable[[Dict], Dict]] = None,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} outside [0, {shard_count})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.transform = transform
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._epoch = 0

    def _shard_len(self) -> int:
        return len(self.dataset) // self.shard_count

    def __len__(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[List[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        if self.shard_count > 1:
            order = order[self.shard_index::self.shard_count][: self._shard_len()]
        batches = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                break
            batches.append(list(idx))
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._epoch += 1
        batches = self._index_batches()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Hand ``item`` to the consumer unless it has gone away."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx in batches:
                        batch = collate(list(pool.map(self.dataset.__getitem__, idx)))
                        if self.transform is not None:
                            batch = self.transform(batch)
                        if not put(batch):
                            return
            except Exception as e:  # the consumer raises it
                put(e)
                return
            put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=10)
