"""In-memory batch loader — the port's copy of ``data/loader.py::ArrayDataLoader``.

numpy only. Batches are ``{"images": [B, H, W, C] float32, "prompt": [B]
int32}`` (NHWC), ``drop_last`` always, and the order is reshuffled every
epoch from one ``np.random.default_rng(seed)``, so the same seed gives the
JAX loader's batches in the same order. Under several processes each takes
its contiguous row slice of every global batch; the rank and world size are
passed in (single process by default), never looked up.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["ArrayDataLoader"]


def _process_slice(batch_size: int, process_index: int, process_count: int) -> slice:
    """This process's contiguous row slice of a global batch."""
    if batch_size % process_count:
        raise ValueError(
            f"global batch {batch_size} not divisible by {process_count} processes"
        )
    local = batch_size // process_count
    return slice(process_index * local, (process_index + 1) * local)


class ArrayDataLoader:
    """Batches over in-memory arrays; reshuffles every epoch."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.images = np.asarray(images, np.float32)
        self.labels = np.asarray(labels, np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._rows = _process_slice(batch_size, process_index, process_count)

    def __len__(self) -> int:
        return len(self.images) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.images))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(len(self)):
            idx = order[i * self.batch_size : (i + 1) * self.batch_size][self._rows]
            yield {"images": self.images[idx], "prompt": self.labels[idx]}
