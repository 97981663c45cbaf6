"""Shared setup for the chexpert-dit experiment — port of ``experiments/chexpert-dit/common.py``.

DiT 384 wide (``384 // attention_head_dim`` heads, 6 × 64 by default), 12
layers, patch size from the config; with the Haar DWT a 256 px, 3-channel
image enters as 128 × 128 × 12. The synthetic data set is the port's copy
of the JAX package's (same arrays, same 256 train / 64 val split, same
shuffles for the same seed).
"""

from __future__ import annotations

import torch

from ..data.synthetic import SyntheticDataLoader
from ..engine import DiffusionClassifier
from ..models.dit import DiT, DiTConfig
from ..utils.config import ExperimentConfig

__all__ = ["build_backbone", "build_data", "build_engine"]

WIDTH = 384
NUM_LAYERS = 12


def build_backbone(config: ExperimentConfig) -> DiT:
    dtype = torch.bfloat16 if config.mixed_precision == "bf16" else torch.float32
    wt = config.wavelet_transform
    head_dim = config.attention_head_dim or 64
    if WIDTH % head_dim:
        raise ValueError(f"head_dim {head_dim} must divide width {WIDTH}")
    channels = 4 * config.image_channels if wt else config.image_channels
    return DiT(
        DiTConfig(
            num_attention_heads=WIDTH // head_dim,
            attention_head_dim=head_dim,
            in_channels=channels,
            out_channels=channels,
            num_layers=NUM_LAYERS,
            sample_size=config.image_size // 2 if wt else config.image_size,
            patch_size=config.patch_size,
            num_classes=config.classes,
            attn_backend=config.attn_backend,
            remat=config.remat,
        ),
        dtype=dtype,
    )


def build_data(config: ExperimentConfig) -> SyntheticDataLoader:
    if config.data_path != "synthetic":
        raise NotImplementedError(
            "the CheXpert loader is not wired into the port yet (ROADMAP A11); "
            "use data_path 'synthetic'"
        )
    return SyntheticDataLoader(
        256, 64,
        batch_size=config.batch_size,
        image_size=config.image_size,
        channels=config.image_channels,
        classes=config.classes,
        seed=config.seed,
    )


def build_engine(config: ExperimentConfig, device="cuda") -> DiffusionClassifier:
    # encoder_type='DiT': integer labels go straight to the backbone's table
    if config.encoder_type != "DiT":
        raise ValueError("chexpert-dit uses encoder_type='DiT'")
    return DiffusionClassifier(build_backbone(config), config, device=device)
