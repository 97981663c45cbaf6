"""Synthetic class-conditional data set — the port's copy of ``data/synthetic.py``.

Each class is a fixed smooth template in [-1, 1] plus per-sample noise, so a
trained denoiser can separate the classes without any data on disk. The
same seed gives the JAX module's arrays, and the same train and val batches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .loader import ArrayDataLoader

__all__ = ["make_synthetic_arrays", "SyntheticDataLoader"]


def make_synthetic_arrays(
    num_items: int,
    *,
    image_size: int = 32,
    channels: int = 3,
    classes: int = 10,
    noise: float = 0.1,
    seed: int = 0,
):
    """``(images [N, H, W, C] float32 in [-1, 1], labels [N] int32, templates)``."""
    rng = np.random.default_rng(seed)
    # smooth per-class templates: random low-frequency sinusoid mixtures
    yy, xx = np.meshgrid(
        np.linspace(0, 1, image_size), np.linspace(0, 1, image_size), indexing="ij"
    )
    templates = np.zeros((classes, image_size, image_size, channels), np.float32)
    for c in range(classes):
        for ch in range(channels):
            fx, fy = rng.integers(1, 4, 2)
            phase = rng.uniform(0, 2 * np.pi)
            templates[c, :, :, ch] = np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
    templates *= 0.8
    labels = rng.integers(0, classes, num_items).astype(np.int32)
    images = templates[labels] + noise * rng.standard_normal(
        (num_items, image_size, image_size, channels)
    ).astype(np.float32)
    return np.clip(images, -1, 1).astype(np.float32), labels, templates


class SyntheticDataLoader:
    """Train/val loader pair: the first ``num_train`` items shuffled by seed, the rest in order.

    ``cf_label`` forces every prompt to that class (counterfactual explanation).
    """

    def __init__(
        self,
        num_train: int = 512,
        num_val: int = 128,
        *,
        batch_size: int = 32,
        image_size: int = 32,
        channels: int = 3,
        classes: int = 10,
        seed: int = 0,
        cf_label: Optional[int] = None,
    ):
        xs, ys, self.templates = make_synthetic_arrays(
            num_train + num_val,
            image_size=image_size,
            channels=channels,
            classes=classes,
            seed=seed,
        )
        if cf_label is not None:
            # counterfactual label forcing: every prompt becomes cf_label,
            # the images keep their true class content
            ys = np.full_like(ys, int(cf_label))
        self._train = ArrayDataLoader(
            xs[:num_train], ys[:num_train], batch_size, shuffle=True, seed=seed
        )
        self._val = ArrayDataLoader(
            xs[num_train:], ys[num_train:], batch_size, shuffle=False, seed=seed
        )

    def get_train_loader(self):
        return self._train

    def get_val_loader(self):
        return self._val

    def get_test_loader(self):
        return self._val
