"""Out-of-distribution loader selection — the port's copy of ``data/ood.py``.

``make_ood_loader(name, config)`` gives one loader of ``{"images",
"prompt"}`` batches for ``name`` in :data:`OOD_DATASETS`, each at its
reference geometry: MIMIC and PadChest at 64 px over the whole set (the
resolution mismatch against 256 px training is the reference's intended
stress), ISIC at 256 px over its test split. ``data_path "synthetic"``
gives the synthetic set's val loader instead, as in the JAX module.
"""

from __future__ import annotations

__all__ = ["OOD_DATASETS", "make_ood_loader"]

OOD_DATASETS = ("mimic", "padchest", "isic")


def make_ood_loader(name: str, config):
    """The evaluation loader of OOD data set ``name`` under ``config``."""
    if name not in OOD_DATASETS:
        raise ValueError(f"unknown OOD dataset {name!r}; choose from {OOD_DATASETS}")
    if config.data_path == "synthetic":
        from .synthetic import SyntheticDataLoader

        return SyntheticDataLoader(
            num_train=config.batch_size,
            num_val=4 * config.batch_size,
            batch_size=config.batch_size,
            image_size=config.image_size,
            channels=config.image_channels,
            classes=config.classes,
            seed=config.seed,
        ).get_val_loader()
    if name == "mimic":
        from .mimic import MimicOodDataLoader

        return MimicOodDataLoader(
            wavelet_transform=config.wavelet_transform,
            data_path=config.data_path,
            batch_size=config.batch_size,
            num_workers=config.num_workers,
            seed=config.seed,
            fast_decode=config.fast_decode,
        ).get_data_loader()
    if name == "padchest":
        from .padchest import PadChestDataLoader

        return PadChestDataLoader(
            wavelet_transform=config.wavelet_transform,
            data_path=config.data_path,
            batch_size=config.batch_size,
            num_workers=config.num_workers,
            seed=config.seed,
        ).get_data_loader()
    from .isic import ISICDataLoader

    return ISICDataLoader(
        wavelet_transform=config.wavelet_transform,
        data_path=config.data_path,
        batch_size=config.batch_size,
        num_workers=config.num_workers,
        seed=config.seed,
        fast_decode=config.fast_decode,
    ).get_test_loader()
