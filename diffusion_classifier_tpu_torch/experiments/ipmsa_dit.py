"""The IPMSA experiment with a DiT denoiser — port of ``experiments/ipmsa-dit/common.py``.

The backbone is the CheXpert DiT's (:func:`.chexpert_dit.build_backbone`;
the two JAX ``common.py`` build the same network): 384 wide,
``384 // attention_head_dim`` heads (6 × 64 by default; the head dim must
divide 384), 12 layers, patch size from the config. With 5 slices and the
Haar DWT a 256 px image enters as 128 × 128 × 40; at patch 4 that is 1024
tokens of 6 × 64, inside the flash kernels' gate. The data and the entry
points' bodies are :mod:`.ipmsa`'s.
"""

from __future__ import annotations

from ..engine import DiffusionClassifier
from ..utils.config import ExperimentConfig
from .chexpert_dit import build_backbone
from .ipmsa import build_data

__all__ = ["build_backbone", "build_data", "build_engine"]


def build_engine(config: ExperimentConfig, device="cuda") -> DiffusionClassifier:
    # encoder_type='DiT': integer labels go straight to the backbone's table
    if config.encoder_type != "DiT":
        raise ValueError("ipmsa-dit uses encoder_type='DiT'")
    return DiffusionClassifier(build_backbone(config), config, device=device)
