"""ISIC melanoma set — the port's copy of ``data/isic.py``.

The reference's ``dataset/isic.py``: the pre-balanced ``train_balanced.csv``
(``image_name``, ``target``), the 80 / 10 / 10 split by row order as
CheXpert's, items ``images/<name>.jpg`` → RGB → bilinear resize → [-1, 1].
With ``cf_label`` every prompt is that label and the true labels travel
along as ``original_labels`` (counterfactual evaluation).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import loader
from .chexpert import split_frame
from .loader import MapDataLoader, Prefetcher

__all__ = ["ISICDataLoader", "ISICDataset"]


class ISICDataset:
    def __init__(
        self,
        data_path: str,
        split: str = "train",
        wavelet_transform: bool = False,
        image_size: int = 256,
        fast_decode: bool = False,
    ):
        self.wavelet_transform = wavelet_transform
        self.data_path = data_path
        self.image_size = image_size
        self.fast_decode = fast_decode
        import pandas as pd

        df = pd.read_csv(os.path.join(data_path, "train_balanced.csv"))
        df = df[split_frame(len(df), split)]
        self.names = df["image_name"].tolist()
        self.labels = df["target"].astype(int).to_numpy()
        print(f"Dataset length: {len(self.names)}")

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int):
        path = os.path.join(self.data_path, "images", f"{self.names[idx]}.jpg")
        img = loader.decode_image(path, self.image_size, fast=self.fast_decode)
        return (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5, int(self.labels[idx])


class _ISICBatcher(MapDataLoader):
    """:class:`MapDataLoader` over a dataset, with the ``cf_label`` override and ``original_labels``."""

    def __init__(self, dataset, batch_size, shuffle, seed, cf_label, num_workers=0,
                 process_index=None, process_count=None):
        super().__init__(
            len(dataset), dataset.__getitem__, batch_size, shuffle=shuffle, seed=seed,
            num_workers=num_workers, process_index=process_index, process_count=process_count,
        )
        self.cf_label = cf_label

    def __iter__(self):
        for batch in super().__iter__():
            if self.cf_label is not None:
                batch["original_labels"] = batch["prompt"]
                batch["prompt"] = np.full_like(batch["prompt"], self.cf_label)
            yield batch


class ISICDataLoader:
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
    ):
        def make(split, shuffle):
            ds = ISICDataset(data_path, split, wavelet_transform, image_size, fast_decode=fast_decode)
            return ds, Prefetcher(
                _ISICBatcher(ds, batch_size, shuffle, seed, cf_label, num_workers=num_workers)
            )

        self.train_dataset, self.train_loader = make("train", True)
        self.val_dataset, self.val_loader = make("valid", False)
        self.test_dataset, self.test_loader = make("test", False)

    def get_train_loader(self):
        return self.train_loader

    def get_val_loader(self):
        return self.val_loader

    def get_test_loader(self):
        return self.test_loader
