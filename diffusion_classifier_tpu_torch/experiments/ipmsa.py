"""The IPMSA experiment (MS future activity) — port of ``experiments/ipmsa/common.py`` and its scripts' bodies.

The reference's 5-level conditional UNet: blocks (128, 256, 256, 512, 768),
layers (2, 2, 4, 4, 4), plain down levels 0-2 (the condition-free prefix)
and cross-attention at levels 3-4, in the mid block and in up levels 0-1,
8 heads a level (``attention_head_dim`` is the head count, the diffusers
quirk), a 256-wide ``'nn'`` class embedding through ``text_proj`` into a
256-wide cross-attention. With 5 slices a 256 px image has 10 channels
(the W000 FLAIR and CT2F slabs); the Haar DWT makes it 128 × 128 × 40. Level
3 then holds 16 × 16 = 256 tokens of 8 × 64 (inside the flash kernels'
gate); level 4 and the mid block 8 × 8 = 64 tokens of 8 × 96 (outside it:
plain attention, as in the JAX package).

What the IPMSA family (this UNet, :mod:`.ipmsa_dit`,
:mod:`.ipmsa_classifier`) shares is here too:

- :func:`build_data` — the synthetic set, or the three split pickles under
  ``<experiment>/split/`` over the volumes at ``$DATA_PATH`` (``$TMPDIR``
  with ``slurm``), through :func:`..data.ipmsa.make_default_transform`;
- the diffusion scripts run :mod:`.common`'s train and inference bodies with
  it and ``make_ipmsa_plotter``;
- :func:`explain_main`, the counterfactual explanation — for each of active
  and inactive, every prompt forced to that label, the real image re-noised
  to t = 0.5 and sampled back under it.

It takes ``--device`` (default ``cuda``) and reads its config from the
environment, as the JAX script does; ``plot_function=None`` takes
``make_ipmsa_plotter(config)``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..data.ipmsa import IPMSADataLoader, make_default_transform
from ..data.synthetic import SyntheticDataLoader
from ..engine import DiffusionClassifier
from ..models.unet import UNetCondition2D, UNetConfig
from ..utils.config import ExperimentConfig
from ..utils.plotters import make_ipmsa_plotter
from .common import BuildEngine, device_of, parser

__all__ = [
    "EXPLAIN_FROM_T",
    "build_backbone",
    "build_data",
    "build_engine",
    "explain_main",
]

# explain.py's re-noising depth: the real image diffused to t = 0.5, sampled back
EXPLAIN_FROM_T = 0.5


def build_backbone(config: ExperimentConfig) -> UNetCondition2D:
    dtype = torch.bfloat16 if config.mixed_precision == "bf16" else torch.float32
    wt = config.wavelet_transform
    channels = 4 * config.image_channels if wt else config.image_channels
    return UNetCondition2D(
        UNetConfig(
            sample_size=config.image_size // 2 if wt else config.image_size,
            in_channels=channels,
            out_channels=channels,
            layers_per_block=(2, 2, 4, 4, 4),
            block_out_channels=(128, 256, 256, 512, 768),
            down_block_types=(
                "DownBlock2D", "DownBlock2D", "DownBlock2D",
                "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
            ),
            up_block_types=(
                "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D", "UpBlock2D", "UpBlock2D",
            ),
            mid_block_type="UNetMidBlock2DCrossAttn",
            encoder_hid_dim=256,
            encoder_hid_dim_type="text_proj",
            cross_attention_dim=256,
            attn_backend=config.attn_backend,
            remat=config.remat,
        ),
        dtype=dtype,
    )


def build_data(config: ExperimentConfig, cf_label: Optional[int] = None):
    """The synthetic set (128 train, 32 val), or the split pickles over the MRI volumes."""
    if config.data_path == "synthetic":
        return SyntheticDataLoader(
            128, 32,
            batch_size=config.batch_size,
            image_size=config.image_size,
            channels=config.image_channels,
            classes=config.classes,
            seed=config.seed,
            cf_label=cf_label,
        )
    transform = make_default_transform(
        slices=config.slices, wavelet_transform=config.wavelet_transform, cf_label=cf_label
    )
    split = os.path.join(config.experiment_path, "split")
    return IPMSADataLoader(
        os.path.join(split, "train_dataset_filtered.pkl"),
        os.path.join(split, "val_dataset_filtered.pkl"),
        os.path.join(split, "test_dataset_filtered.pkl"),
        transform,
        config.slurm,
        config.batch_size,
        config.num_workers,
        seed=config.seed,
    )


def build_engine(config: ExperimentConfig, device="cuda") -> DiffusionClassifier:
    return DiffusionClassifier(build_backbone(config), config, device=device)


def explain_main(build_engine: BuildEngine, argv=None, plot_function=None, description=None):
    """The counterfactual explanation for each label; returns ``{True: (samples, batches), False: ...}``.

    For ``active_label`` in (True, False): the test loader with every prompt
    forced to ``int(active_label)``, then ``inference(classification=False,
    from_t=0.5)`` — each real image re-noised to t = 0.5 and sampled back
    over ``sampling_steps`` steps under the forced condition, plotted.
    """
    args = parser(description).parse_args(argv)
    device = device_of(args)
    out = {}
    for active_label in (True, False):
        config = ExperimentConfig.from_env("INFERENCE_CONFIG")
        data = build_data(config, cf_label=int(active_label))
        engine = build_engine(config, device=device)
        out[active_label] = engine.inference(
            val_dataloader=data.get_test_loader(),
            plot_function=plot_function or make_ipmsa_plotter(config),
            classification=False,
            from_t=EXPLAIN_FROM_T,
            checkpoint_folder=config.checkpoint_folder,
        )
    return out
