"""DiT-XL/2 scoring 512 px ImageNet latents: the published class-conditional DiT as a classifier.

The ``dit-xl-2`` preset (``models/presets.py``): ``facebook/DiT-XL-2-512``'s
transformer (Peebles and Xie, arXiv 2212.09748, Table 1: XL/2), 28 blocks
1152 wide, 16 heads × 72, patch 2 over 64 × 64 × 4 SD-VAE latents (1,024
tokens), ``classes`` labels and the null label, and 8 output channels: ε
and the learned Σ. The denoiser hands the classifier, the sampler and the
loss the ε half (``engine/denoiser.py``); training the Σ half (DiT's
variational-bound term) is not part of the port. Li et al. (arXiv
2303.16203) score ImageNet with this model by the same per-class ε-error
tournament (``diffusion/classify.py``).

``data_path "synthetic"`` gives the port's seeded synthetic set at the
config's ``image_size`` (64) and ``image_channels`` (4): latent-shaped
arrays in [-1, 1] standing for VAE latents, no VAE run. Real ImageNet
latents need the SD-VAE encoder's weights and the published checkpoint,
which the repository does not hold; any other ``data_path`` is refused.
"""

from __future__ import annotations

from ..data.synthetic import SyntheticDataLoader
from ..engine import DiffusionClassifier
from ..models.dit import DiT
from ..models.presets import build_preset
from ..utils.config import ExperimentConfig

__all__ = ["build_backbone", "build_data", "build_engine"]


def build_backbone(config: ExperimentConfig) -> DiT:
    return build_preset("dit-xl-2", config)


def build_engine(config: ExperimentConfig, device="cuda") -> DiffusionClassifier:
    # encoder_type='DiT': integer labels go straight to the backbone's table
    if config.encoder_type != "DiT":
        raise ValueError("imagenet-dit uses encoder_type='DiT'")
    return DiffusionClassifier(build_backbone(config), config, device=device)


def build_data(config: ExperimentConfig):
    if config.data_path != "synthetic":
        raise ValueError(
            "imagenet-dit reads no image set yet: ImageNet latents need the SD-VAE encoder, "
            "which the repository does not hold; use data_path 'synthetic'"
        )
    return SyntheticDataLoader(
        256, 64,
        batch_size=config.batch_size,
        image_size=config.image_size,
        channels=config.image_channels,
        classes=config.classes,
        seed=config.seed,
    )
