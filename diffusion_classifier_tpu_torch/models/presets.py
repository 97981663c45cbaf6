"""Named architecture presets — the port's copy of ``models/presets.py``.

Each preset is a function ``(config) -> backbone config`` with the JAX
package's hyperparameters (``dit-xl-2``, the published DiT-XL/2, is the
port's alone); :func:`build_preset` returns the port's
:class:`~.unet.UNetCondition2D` or :class:`~.dit.DiT` at the config's
dtype. Every UNet preset conditions through ``text_proj`` onto a 512-wide
cross-attention context with a cross-attention mid block. Presets read
``image_channels``, ``image_size`` and ``wavelet_transform`` (the Haar DWT
gives 4× the channels at half the size), ``patch_size`` and ``classes``
(the DiT), ``attn_backend`` and ``remat``.
"""

from __future__ import annotations

import torch

from .dit import DiT, DiTConfig
from .unet import UNetCondition2D, UNetConfig

__all__ = ["DIT_PRESETS", "UNET_PRESETS", "build_preset"]


def _io(config):
    wt = config.wavelet_transform
    ch = 4 * config.image_channels if wt else config.image_channels
    size = config.image_size // 2 if wt else config.image_size
    return ch, size


def _cond_unet(config, **arch) -> UNetConfig:
    """The conditioning every UNet preset shares; the presets give the architecture."""
    return UNetConfig(
        mid_block_type="UNetMidBlock2DCrossAttn",
        encoder_hid_dim=512,
        encoder_hid_dim_type="text_proj",
        cross_attention_dim=512,
        attn_backend=config.attn_backend,
        remat=config.remat,
        **arch,
    )


def unet_128(config) -> UNetConfig:
    """`models/unet-128.py`: 5 levels (128, 128, 256, 512, 1024), cross-attention at level 3."""
    ch, size = _io(config)
    return _cond_unet(
        config,
        sample_size=size,
        in_channels=ch,
        out_channels=ch,
        layers_per_block=2,
        block_out_channels=(128, 128, 256, 512, 1024),
        down_block_types=(
            "DownBlock2D", "DownBlock2D", "DownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
        ),
        up_block_types=(
            "UpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D", "UpBlock2D", "UpBlock2D",
        ),
    )


def unet_256(config) -> UNetConfig:
    """`models/unet-256.py`: 6 levels (128, 128, 256, 256, 512, 1024), cross-attention at level 4."""
    ch, size = _io(config)
    return _cond_unet(
        config,
        sample_size=size,
        in_channels=ch,
        out_channels=ch,
        layers_per_block=2,
        block_out_channels=(128, 128, 256, 256, 512, 1024),
        down_block_types=(
            "DownBlock2D", "DownBlock2D", "DownBlock2D",
            "DownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
        ),
        up_block_types=(
            "UpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D",
            "UpBlock2D", "UpBlock2D", "UpBlock2D",
        ),
    )


def chexpert_256_unet_dwt_healthysick(config) -> UNetConfig:
    """`models/chexpert-256-unet-dwt-healthysick.py`: fixed 128 px, 12 channels (a 256 px DWT)."""
    return _cond_unet(
        config,
        sample_size=128,
        in_channels=12,
        out_channels=12,
        layers_per_block=2,
        block_out_channels=(128, 128, 256, 512, 1024),
        down_block_types=(
            "DownBlock2D", "DownBlock2D", "DownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
        ),
        up_block_types=(
            "UpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D", "UpBlock2D", "UpBlock2D",
        ),
    )


def ipmsa_5_unet(config) -> UNetConfig:
    """`models/ipmsa-5-unet.py`: 256 px, 10 channels, 6 levels with 4 resnets at level 4."""
    return _cond_unet(
        config,
        sample_size=256,
        in_channels=10,
        out_channels=10,
        layers_per_block=(2, 2, 2, 2, 4, 2),
        block_out_channels=(128, 128, 256, 512, 512, 1024),
        down_block_types=(
            "DownBlock2D", "DownBlock2D", "DownBlock2D",
            "DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        ),
        up_block_types=(
            "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D",
            "UpBlock2D", "UpBlock2D", "UpBlock2D",
        ),
    )


def ipmsa_5_dwt_unet(config) -> UNetConfig:
    """`models/ipmsa-5-dwt-unet.py`: 128 px, 40 channels (a 256 px DWT), 4 resnets at level 3."""
    return _cond_unet(
        config,
        sample_size=128,
        in_channels=40,
        out_channels=40,
        layers_per_block=(2, 2, 2, 4, 2),
        block_out_channels=(128, 128, 256, 512, 768),
        down_block_types=(
            "DownBlock2D", "DownBlock2D", "DownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
        ),
        up_block_types=(
            "UpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D", "UpBlock2D", "UpBlock2D",
        ),
    )


def chexpert_256_dit_b4(config) -> DiTConfig:
    """`models/chexpert-256-dit-b4.py`: DiT-B, 12 heads × 64, 12 layers, patch size from the config."""
    ch, size = _io(config)
    return DiTConfig(
        num_attention_heads=12,
        attention_head_dim=64,
        in_channels=ch,
        out_channels=ch,
        num_layers=12,
        sample_size=size,
        patch_size=config.patch_size,
        num_classes=config.classes,
        attn_backend=config.attn_backend,
        remat=config.remat,
    )


def dit_xl_2(config) -> DiTConfig:
    """DiT-XL/2 (Peebles and Xie, arXiv 2212.09748, Table 1; ``facebook/DiT-XL-2-512``).

    28 layers, 16 heads × 72 (1152 wide), patch 2, ``out_channels`` twice
    the input's (ε and the learned Σ; the denoiser hands on the ε half),
    the sample size and class count from the config: 1,024 tokens and 1,000
    classes on 512 px ImageNet's 64 × 64 × 4 latents.
    """
    ch, size = _io(config)
    return DiTConfig(
        num_attention_heads=16,
        attention_head_dim=72,
        in_channels=ch,
        out_channels=2 * ch,
        num_layers=28,
        sample_size=size,
        patch_size=2,
        num_classes=config.classes,
        attn_backend=config.attn_backend,
        remat=config.remat,
    )


UNET_PRESETS = {
    "unet-128": unet_128,
    "unet-256": unet_256,
    "chexpert-256-unet-dwt-healthysick": chexpert_256_unet_dwt_healthysick,
    "ipmsa-5-unet": ipmsa_5_unet,
    "ipmsa-5-dwt-unet": ipmsa_5_dwt_unet,
}
DIT_PRESETS = {"chexpert-256-dit-b4": chexpert_256_dit_b4, "dit-xl-2": dit_xl_2}


def build_preset(name: str, config):
    """The preset backbone ``name`` at the config's dtype (bf16 under ``mixed_precision='bf16'``)."""
    dtype = torch.bfloat16 if config.mixed_precision == "bf16" else torch.float32
    if name in UNET_PRESETS:
        return UNetCondition2D(UNET_PRESETS[name](config), dtype)
    if name in DIT_PRESETS:
        return DiT(DIT_PRESETS[name](config), dtype)
    raise ValueError(
        f"unknown preset {name!r}; available: {sorted(UNET_PRESETS) + sorted(DIT_PRESETS)}"
    )
