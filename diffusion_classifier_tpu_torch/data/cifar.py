"""CIFAR-10 from the ``cifar-10-batches-py`` pickles — the port's copy of ``data/cifar.py``.

numpy only, no torchvision and no download: ``data_path`` holds
``cifar-10-batches-py/`` (or is that folder), or ``cifar-10-python.tar.gz``,
which is extracted in place with ``filter="data"``. Normalisation is mean
and std 0.5 per channel, so values lie in [-1, 1]; images are NHWC. Batches
are ``{"images": [B, 32, 32, 3] float32, "prompt": [B] int32}`` from the
port's :class:`~.loader.ArrayDataLoader`: the same seed gives the JAX
loader's batches in the same order.
"""

from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from .loader import ArrayDataLoader

__all__ = ["CIFAR10_CLASSES", "CIFAR10DataLoader", "load_cifar10_arrays"]

CIFAR10_CLASSES = [
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
]


def _find_batches_dir(data_path: str) -> str:
    for candidate in (os.path.join(data_path, "cifar-10-batches-py"), data_path):
        if os.path.isfile(os.path.join(candidate, "data_batch_1")):
            return candidate
    tar = os.path.join(data_path, "cifar-10-python.tar.gz")
    if os.path.isfile(tar):
        with tarfile.open(tar) as tf:
            tf.extractall(data_path, filter="data")
        return os.path.join(data_path, "cifar-10-batches-py")
    raise FileNotFoundError(
        f"CIFAR-10 not found under {data_path!r} (expected cifar-10-batches-py/"
        " or cifar-10-python.tar.gz; this loader cannot download)"
    )


def _load_batch(path: str):
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return images, np.asarray(d[b"labels"], np.int32)


def load_cifar10_arrays(data_path: str):
    """``(train_images, train_labels, test_images, test_labels)``, images NHWC float32 in [-1, 1]."""
    root = _find_batches_dir(data_path)
    train = [_load_batch(os.path.join(root, f"data_batch_{i}")) for i in range(1, 6)]
    xs = np.concatenate([b[0] for b in train])
    ys = np.concatenate([b[1] for b in train])
    xt, yt = _load_batch(os.path.join(root, "test_batch"))

    def norm(a):
        return (a.astype(np.float32) / 255.0 - 0.5) / 0.5

    return norm(xs), ys, norm(xt), yt


class CIFAR10DataLoader:
    """The train split shuffled every epoch from ``seed``, the test split in file order."""

    def __init__(
        self,
        data_path: str,
        batch_size: int,
        num_workers: int = 0,  # accepted for the config's sake; the arrays are in memory
        *,
        seed: int = 0,
    ):
        del num_workers
        xs, ys, xt, yt = load_cifar10_arrays(data_path)
        self._train = ArrayDataLoader(xs, ys, batch_size, shuffle=True, seed=seed)
        self._test = ArrayDataLoader(xt, yt, batch_size, shuffle=False, seed=seed)

    def get_train_loader(self) -> ArrayDataLoader:
        return self._train

    def get_test_loader(self) -> ArrayDataLoader:
        return self._test
