"""MIMIC-CXR out-of-distribution set — the port's copy of ``data/mimic.py``.

The reference's ``dataset/mimic.py``: ``mimic_pa_metadata.csv``, columns
``image_path`` and ``Pleural Effusion`` (empty → 0, −1 dropped), balanced by
taking the first ``min_count`` rows of each label (label 0 first), one
shuffled loader and no splits. An item's file is its ``image_path`` without
the first two parts, under ``data_path``. Items are resized to 64 px and
stay in [0, 1]: the reference's normalisation is commented out, and the
port keeps that quirk.
"""

from __future__ import annotations

import os

import numpy as np

from . import loader
from .loader import MapDataLoader, Prefetcher

__all__ = ["MimicOodDataLoader", "MimicOodDataset"]

LABEL = "Pleural Effusion"


class MimicOodDataset:
    def __init__(
        self,
        data_path: str,
        wavelet_transform: bool = False,
        image_size: int = 64,
        fast_decode: bool = False,
    ):
        self.wavelet_transform = wavelet_transform
        self.data_path = data_path
        self.image_size = image_size
        self.fast_decode = fast_decode
        import pandas as pd

        df = pd.read_csv(os.path.join(data_path, "mimic_pa_metadata.csv"))
        df = df[["image_path", LABEL]].fillna({LABEL: 0})
        zeros, ones = df[df[LABEL] == 0], df[df[LABEL] == 1]
        n = min(len(zeros), len(ones))
        df = pd.concat([zeros.head(n), ones.head(n)])
        self.paths = df["image_path"].tolist()
        self.labels = df[LABEL].astype(int).to_numpy()
        print(f"Dataset length: {len(self.paths)}")

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int):
        path = os.path.join(self.data_path, *self.paths[idx].split("/")[2:])
        img = loader.decode_image(path, self.image_size, fast=self.fast_decode)
        return np.asarray(img, np.float32) / 255.0, int(self.labels[idx])  # stays in [0, 1]


class MimicOodDataLoader:
    """One shuffled loader over the whole set, behind a :class:`Prefetcher`."""

    def __init__(
        self,
        wavelet_transform: bool,
        data_path: str,
        batch_size: int = 64,
        num_workers: int = 4,
        *,
        image_size: int = 64,
        seed: int = 0,
        fast_decode: bool = False,
    ):
        ds = MimicOodDataset(data_path, wavelet_transform, image_size, fast_decode=fast_decode)
        self.dataset = ds
        self.data_loader = Prefetcher(MapDataLoader(
            len(ds), ds.__getitem__, batch_size, shuffle=True, seed=seed, num_workers=num_workers,
        ))

    def get_data_loader(self):
        return self.data_loader
