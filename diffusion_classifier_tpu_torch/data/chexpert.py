"""CheXpert Pleural Effusion vs No Finding — the port's copy of ``data/chexpert.py``.

The filter of the reference's ``dataset/chexpert.py``, in pandas (imported
when a CSV is read):

- rows whose ``Path`` contains ``study1/view1_frontal.jpg``;
- ``Pleural Effusion`` and ``No Finding``, empty → 0, rows with −1 in
  either dropped;
- rows where exactly one of (effusion > 0, no finding > 0) holds;
- ``min_count`` rows of each label sampled with seed 42, the two sets
  concatenated (effusion first) and shuffled with seed 42;
- the 80 / 10 / 10 split by row order.

Items: decode (optionally through the :class:`.decode_cache.DecodeCache`)
→ RGB → bilinear resize to ``image_size`` → [-1, 1], NHWC float32. The Haar
DWT is not applied here: the engine applies it on the device when
``wavelet_transform`` is set. ``cf_label`` replaces every label (the
counterfactual loaders).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import loader
from .loader import MapDataLoader, Prefetcher

__all__ = ["CheXpertDataLoader", "CheXpertDataset", "load_chexpert_rows", "split_frame"]

EFFUSION, NO_FINDING = "Pleural Effusion", "No Finding"


def load_chexpert_rows(csv_path: str) -> tuple[list[str], np.ndarray]:
    """``(paths, labels)`` of the balanced, shuffled frame (``_load_frame`` of the JAX module)."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    df = df[df["Path"].str.contains("study1/view1_frontal.jpg", regex=False)]
    df = df[["Path", EFFUSION, NO_FINDING]].fillna({EFFUSION: 0, NO_FINDING: 0})
    df = df[(df[EFFUSION] != -1) & (df[NO_FINDING] != -1)]
    df = df[(df[EFFUSION] > 0) ^ (df[NO_FINDING] > 0)]
    active, inactive = df[df[EFFUSION] == 1], df[df[EFFUSION] == 0]
    n = min(len(active), len(inactive))
    df = pd.concat([active.sample(n=n, random_state=42), inactive.sample(n=n, random_state=42)])
    df = df.sample(n=len(df), random_state=42)  # shuffle
    return df["Path"].tolist(), df[EFFUSION].astype(int).to_numpy()


def split_frame(n: int, split: str) -> slice:
    """Rows of ``split`` among ``n``, by row order: 80 / 10 / 10.

    ``head(int(n·0.8))``, ``tail(int(n·0.2)).head(t // 2)`` and
    ``tail(int(n·0.2)).tail(t // 2)``: a 20% tail of odd length drops its
    middle row.
    """
    tail = int(n * 0.2)
    half = tail // 2
    if split == "train":
        return slice(0, int(n * 0.8))
    if split == "valid":
        return slice(n - tail, n - tail + half)
    if split == "test":
        return slice(n - half, n)
    raise ValueError(f"unknown split {split!r}")


def _to_unit_range(arr: np.ndarray) -> np.ndarray:
    """uint8 RGB → float32 in [-1, 1] (``Normalize(0.5, 0.5)`` after ``/ 255``)."""
    arr = np.asarray(arr, np.float32) / 255.0
    return (arr - 0.5) / 0.5


class CheXpertDataset:
    """One split of the filtered frame; ``ds[i] -> (image [H, W, 3] float32, label)``."""

    def __init__(
        self,
        data_path: str,
        split: str = "train",
        wavelet_transform: bool = False,
        image_size: int = 256,
        fast_decode: bool = False,
        decode_cache_dir: Optional[str] = None,
    ):
        self.wavelet_transform = wavelet_transform  # applied by the engine, on the device
        self.data_path = data_path
        self.image_size = image_size
        self.fast_decode = fast_decode
        self._decode_cache = None
        if decode_cache_dir:
            from .decode_cache import DecodeCache

            self._decode_cache = DecodeCache(decode_cache_dir, image_size, fast=fast_decode)
        paths, labels = load_chexpert_rows(os.path.join(data_path, "train.csv"))
        rows = split_frame(len(paths), split)
        self.paths = paths[rows]
        self.labels = labels[rows]
        print(f"Dataset length: {len(self.paths)}")

    def __len__(self) -> int:
        return len(self.paths)

    def file_path(self, idx: int) -> str:
        """The image file of item ``idx``: its CSV path without the first part, under ``data_path``."""
        return os.path.join(self.data_path, *self.paths[idx].split("/")[1:])

    def __getitem__(self, idx: int):
        full = self.file_path(idx)
        if self._decode_cache is not None:
            arr = self._decode_cache.get_or_decode(full)
        else:
            arr = loader.decode_image(full, self.image_size, fast=self.fast_decode)
        return _to_unit_range(arr), int(self.labels[idx])

    def mistake_paths(self, predictions) -> list[str]:
        """Relative paths of the misclassified items, in order (the ``mistakes-*.txt`` format)."""
        return [
            os.path.join(*self.paths[i].split("/")[1:])
            for i, pred in enumerate(predictions)
            if int(pred) != int(self.labels[i])
        ]


class CheXpertDataLoader:
    """Train (shuffled), valid and test loaders over the three splits, each behind a :class:`Prefetcher`."""

    def __init__(
        self,
        wavelet_transform: bool,
        data_path: str,
        cf_label: Optional[int] = None,
        batch_size: int = 64,
        num_workers: int = 4,
        *,
        image_size: int = 256,
        seed: int = 0,
        fast_decode: bool = False,
        decode_cache_dir: Optional[str] = None,
    ):
        self.cf_label = cf_label

        def make(split, shuffle):
            ds = CheXpertDataset(
                data_path, split, wavelet_transform, image_size,
                fast_decode=fast_decode, decode_cache_dir=decode_cache_dir,
            )

            def load(i):
                img, label = ds[i]
                return img, label if cf_label is None else cf_label

            batches = MapDataLoader(
                len(ds), load, batch_size, shuffle=shuffle, seed=seed, num_workers=num_workers,
            )
            return ds, Prefetcher(batches)

        self.train_dataset, self.train_loader = make("train", True)
        self.val_dataset, self.val_loader = make("valid", False)
        self.test_dataset, self.test_loader = make("test", False)

    def get_train_loader(self):
        return self.train_loader

    def get_val_loader(self):
        return self.val_loader

    def get_test_loader(self):
        return self.test_loader
