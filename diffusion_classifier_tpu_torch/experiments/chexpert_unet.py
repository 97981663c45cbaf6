"""Shared setup for the chexpert-unet experiment — port of ``experiments/chexpert-unet/common.py``.

The reference's CheXpert UNet: blocks (256, 512, 768), two resnets a level,
plain down levels 0-1 (the condition-free prefix) and cross-attention at
level 2 and in the mid block, 8 heads (96 wide at 768 channels), a 256-wide
``'nn'`` class embedding through ``text_proj`` into a 256-wide
cross-attention. With the Haar DWT a 256 px, 3-channel image enters as
128 × 128 × 12, and level 2 holds 32 × 32 = 1024 tokens. D=96 is outside the
flash kernels' gate (D ∈ {32, 64, 128}), as it is outside the JAX package's,
so both run that attention in plain arithmetic. The data and the mistakes
file are :mod:`.chexpert_common`'s, as for :mod:`.chexpert_dit`.
"""

from __future__ import annotations

import torch

from ..engine import DiffusionClassifier
from ..models.unet import UNetCondition2D, UNetConfig
from ..utils.config import ExperimentConfig
from .chexpert_common import build_data, write_mistakes

__all__ = ["build_backbone", "build_data", "build_engine", "write_mistakes"]


def build_backbone(config: ExperimentConfig) -> UNetCondition2D:
    dtype = torch.bfloat16 if config.mixed_precision == "bf16" else torch.float32
    wt = config.wavelet_transform
    channels = 4 * config.image_channels if wt else config.image_channels
    return UNetCondition2D(
        UNetConfig(
            sample_size=config.image_size // 2 if wt else config.image_size,
            in_channels=channels,
            out_channels=channels,
            layers_per_block=2,
            block_out_channels=(256, 512, 768),
            down_block_types=("DownBlock2D", "DownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "UpBlock2D", "UpBlock2D"),
            mid_block_type="UNetMidBlock2DCrossAttn",
            encoder_hid_dim=256,
            encoder_hid_dim_type="text_proj",
            cross_attention_dim=256,
            attn_backend=config.attn_backend,
            remat=config.remat,
        ),
        dtype=dtype,
    )


def build_engine(config: ExperimentConfig, device="cuda") -> DiffusionClassifier:
    # encoder_type='nn': labels become a one-token context for the cross-attention
    if config.encoder_type != "nn":
        raise ValueError("chexpert-unet uses encoder_type='nn'")
    return DiffusionClassifier(build_backbone(config), config, device=device)
