"""Host-side batch loaders — the port's copy of ``data/loader.py``.

numpy only. Batches are ``{"images": [B, H, W, C] float32, "prompt": [B]
int32}`` (NHWC), ``drop_last`` always, and the order is reshuffled every
epoch from one ``np.random.default_rng(seed)`` per loader, so the same seed
gives the JAX loader's batches in the same order.

- :class:`ArrayDataLoader` batches in-memory arrays.
- :class:`MapDataLoader` batches items computed by ``load_fn(index)``
  (JPEG/PNG decode), serially or on a thread pool
  (:func:`iter_item_batches`); the batches are the same for any worker count.
- :class:`Prefetcher` runs a loader on a background thread, a few batches
  ahead of the consumer.
- :func:`decode_image` is the JPEG datasets' decode: PIL open → optional
  reduced-scale draft → RGB → bilinear resize.

Under several processes ``batch_size`` is the global batch: every process
computes the same shuffle and takes its contiguous row slice of each batch.
The rank and world size are passed in, or, when neither is, read from the
data axis of the mesh, or from ``torch.distributed`` if it is initialised
(else one process).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

__all__ = [
    "ArrayDataLoader",
    "MapDataLoader",
    "Prefetcher",
    "decode_image",
    "iter_item_batches",
]


def decode_image(path: str, image_size: int, *, fast: bool = False):
    """Open → (optional reduced-scale JPEG decode) → RGB → bilinear resize to ``image_size²``.

    With ``fast=True`` PIL's draft mode lets libjpeg decode at the smallest
    DCT scale (1/1 … 1/8) still at least the target, and the resize finishes
    the job: several times less decode work on large sources, pixels within
    resampling noise of the full decode. Other formats ignore the draft.
    Returns a PIL image; PIL is imported here, at the first call.
    """
    from PIL import Image

    img = Image.open(path)
    if fast:
        img.draft(None, (image_size, image_size))
    img = img.convert("RGB")
    return img.resize((image_size, image_size), Image.BILINEAR)


def iter_item_batches(
    index_batches: Iterable[Sequence[int]],
    load_fn: Callable[[int], object],
    num_workers: int = 0,
    window: int = 3,
) -> Iterator[list]:
    """Decode index batches into item lists, serially or on ``num_workers`` threads.

    PIL's decode and resize release the GIL, so threads scale. Item futures
    for up to ``window`` batches stay in flight, and batches come out in
    order, so the output is the serial path's for any worker count. A
    decode error re-raises on the consuming thread at its batch. A consumer
    that stops early cancels the futures not yet started.
    """
    if num_workers <= 0:
        for idx in index_batches:
            yield [load_fn(int(j)) for j in idx]
        return
    pool = ThreadPoolExecutor(max_workers=num_workers)
    try:
        it = iter(index_batches)
        pending: deque = deque()

        def submit_next() -> None:
            idx = next(it, None)
            if idx is not None:
                pending.append([pool.submit(load_fn, int(j)) for j in idx])

        for _ in range(max(window, 1)):
            submit_next()
        while pending:
            futs = pending.popleft()
            submit_next()  # refill before blocking: keeps the pool busy
            yield [f.result() for f in futs]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _process_slice(
    batch_size: int, process_index: Optional[int] = None, process_count: Optional[int] = None
) -> slice:
    """This process's contiguous row slice of a global batch.

    With neither argument, this rank's place on the data axis
    (``parallel.mesh.data_position``: the ranks of one tensor-parallel group
    share rows), else the rank and world size of an initialised
    ``torch.distributed`` group, else (0, 1).
    """
    if (process_index is None) != (process_count is None):
        raise ValueError("pass both process_index and process_count, or neither")
    if process_count is None:
        from ..parallel.mesh import data_position

        process_index, process_count = data_position()
    if batch_size % process_count:
        raise ValueError(
            f"global batch {batch_size} not divisible by {process_count} processes"
        )
    local = batch_size // process_count
    return slice(process_index * local, (process_index + 1) * local)


def _index_batches(order: np.ndarray, batch_size: int, n_batches: int, rows: slice):
    """This process's rows of each of the ``n_batches`` global batches of ``order``."""
    return (order[i * batch_size : (i + 1) * batch_size][rows] for i in range(n_batches))


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
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.images = np.asarray(images, np.float32)
        self.labels = np.asarray(labels, np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._proc = (process_index, process_count)

    def __len__(self) -> int:
        return len(self.images) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        rows = _process_slice(self.batch_size, *self._proc)
        order = np.arange(len(self.images))
        if self.shuffle:
            self._rng.shuffle(order)
        for idx in _index_batches(order, self.batch_size, len(self), rows):
            yield {"images": self.images[idx], "prompt": self.labels[idx]}


class MapDataLoader:
    """Batches computed per item by ``load_fn(index) -> (image, label)``.

    ``num_workers > 0`` decodes on a thread pool (:func:`iter_item_batches`);
    the batches are the same for any worker count. Only this process's rows
    of each global batch are decoded.
    """

    def __init__(
        self,
        num_items: int,
        load_fn: Callable[[int], tuple],
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 0,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.num_items = num_items
        self.load_fn = load_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self._rng = np.random.default_rng(seed)
        self._proc = (process_index, process_count)

    def __len__(self) -> int:
        return self.num_items // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        rows = _process_slice(self.batch_size, *self._proc)
        order = np.arange(self.num_items)
        if self.shuffle:
            self._rng.shuffle(order)
        idx_batches = _index_batches(order, self.batch_size, len(self), rows)
        for items in iter_item_batches(idx_batches, self.load_fn, self.num_workers):
            images = np.stack([im for im, _ in items]).astype(np.float32)
            labels = np.asarray([lb for _, lb in items], np.int32)
            yield {"images": images, "prompt": labels}


class Prefetcher:
    """Runs ``loader`` on a background thread, up to ``depth`` batches ahead.

    A loader error re-raises on the consuming thread. A consumer that stops
    early (an eval leaving at ``stop_idx``) stops the thread: it never
    blocks on a full queue.
    """

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised on the consumer's thread
                put(e)
            else:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # unblocks, does not join: an early exit need not wait for a decode in flight
            stop.set()
