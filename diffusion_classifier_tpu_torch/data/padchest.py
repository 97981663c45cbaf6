"""PadChest out-of-distribution set — the port's copy of ``data/padchest.py``.

The reference's ``dataset/padchest.py``: ``padchest-v1.csv`` with the image
path and the binary ``PleuralEffusion`` label (empty → 0, −1 dropped, no
balancing), one shuffled loader. Items: PIL's bare ``resize`` to 64 px,
whose default filter is bicubic; the 16-bit PNG values divided by 255·255
(the reference's own scale), then mapped to [-1, 1]; a grey image repeated
to 3 channels.
"""

from __future__ import annotations

import os

import numpy as np

from .loader import MapDataLoader, Prefetcher

__all__ = ["PadChestDataLoader", "PadChestDataset"]


class PadChestDataset:
    def __init__(
        self,
        data_path: str,
        wavelet_transform: bool = False,
        image_size: int = 64,
        csv_name: str = "padchest-v1.csv",
        path_col: str = "ImageID",
        label_col: str = "PleuralEffusion",
    ):
        self.data_path = data_path
        self.wavelet_transform = wavelet_transform
        self.image_size = image_size
        import pandas as pd

        df = pd.read_csv(os.path.join(data_path, csv_name))
        df = df[[path_col, label_col]].fillna({label_col: 0})
        df = df[df[label_col] != -1]
        self.paths = df[path_col].tolist()
        self.labels = df[label_col].astype(int).to_numpy()
        print(f"Dataset length: {len(self.paths)}")

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int):
        from PIL import Image

        img = Image.open(os.path.join(self.data_path, self.paths[idx]))
        img = img.resize((self.image_size, self.image_size))  # PIL's default: bicubic
        arr = np.asarray(img, np.float32) / (255.0 * 255.0)  # the 16-bit scale
        arr = (arr - 0.5) / 0.5
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        return arr, int(self.labels[idx])


class PadChestDataLoader:
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
    ):
        ds = PadChestDataset(data_path, wavelet_transform, image_size)
        self.dataset = ds
        self.data_loader = Prefetcher(MapDataLoader(
            len(ds), ds.__getitem__, batch_size, shuffle=True, seed=seed, num_workers=num_workers,
        ))

    def get_data_loader(self):
        return self.data_loader
