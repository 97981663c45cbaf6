"""Shared setup for the cifar10 experiment — port of ``experiments/cifar10/common.py``.

The conditional UNet of the reference's CIFAR-10 experiment (the JAX
package's flagship): blocks (128, 128, 256, 512), two resnets a level,
plain down levels 0-1 (the condition-free prefix) and cross-attention at
levels 2-3 and the mid block (8 heads: 64 tokens × D=32 at level 2, 16
tokens × D=64 at level 3), cross-attention dim 128 over a ``'nn'`` class
embedding of width 128 with ``text_proj``. With ``encoder_type 't5'`` the
context is the T5 class table's ``[S, D]`` a class (``t5_table_path``, or
the table a T5 encoder computes from the config's ``t5_*`` fields):
:func:`build_backbone` reads S and D from the config through
``engine.t5_class_table``, so ``encoder_hid_proj`` maps D to 128, as
flax infers its input width. ``data_path "synthetic"`` gives
the port's synthetic set (512 train, 128 val images); any other path is read
as the ``cifar-10-batches-py`` pickles (:mod:`..data.cifar`).
"""

from __future__ import annotations

import torch

from ..data.cifar import CIFAR10DataLoader
from ..data.synthetic import SyntheticDataLoader
from ..engine import DiffusionClassifier
from ..engine.diffusion_classifier import t5_class_table
from ..models.unet import UNetCondition2D, UNetConfig
from ..utils.config import ExperimentConfig

__all__ = ["build_backbone", "build_data", "build_engine"]


def build_backbone(config: ExperimentConfig) -> UNetCondition2D:
    dtype = torch.bfloat16 if config.mixed_precision == "bf16" else torch.float32
    context = {}
    if config.encoder_type == "t5":
        tokens, width = t5_class_table(config).shape[1:]
        context = dict(context_tokens=tokens, context_dim=width)
    return UNetCondition2D(
        UNetConfig(
            sample_size=config.image_size,
            in_channels=config.image_channels,
            out_channels=config.image_channels,
            layers_per_block=2,
            block_out_channels=(128, 128, 256, 512),
            down_block_types=(
                "DownBlock2D", "DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
            ),
            up_block_types=(
                "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D", "UpBlock2D",
            ),
            encoder_hid_dim=128,
            encoder_hid_dim_type="text_proj",
            cross_attention_dim=128,
            attn_backend=config.attn_backend,
            remat=config.remat,
        ),
        dtype=dtype,
        **context,
    )


def build_data(config: ExperimentConfig):
    if config.data_path == "synthetic":
        return SyntheticDataLoader(
            512, 128,
            batch_size=config.batch_size,
            image_size=config.image_size,
            channels=config.image_channels,
            classes=config.classes,
            seed=config.seed,
        )
    return CIFAR10DataLoader(
        config.data_path, config.batch_size, config.num_workers, seed=config.seed
    )


def build_engine(config: ExperimentConfig, device="cuda") -> DiffusionClassifier:
    # 'nn': a one-token context for the cross-attention; 't5': the table's S tokens
    if config.encoder_type not in ("nn", "t5"):
        raise ValueError("cifar10 uses encoder_type 'nn' or 't5'")
    return DiffusionClassifier(build_backbone(config), config, device=device)
