"""IPMSA ResNet baseline training on the PyTorch/CUDA port (mirrors train.py).

Reads the same ``TRAINING_CONFIG`` JSON (``variant``, ``pretrained``,
``pretrained_path``: a local ``.npz`` of a torchvision state dict) and
trains the ResNet and its linear head with cross-entropy, the four
classification metrics and a checkpoint at each eval. The data is the
IPMSA experiment's. Imports only the port; ``--device`` picks the torch
device (default ``cuda``).

    DATA_PATH=/data/ipmsa TRAINING_CONFIG='{"data_path": "volumes", "variant": "resnet50",
        "image_channels": 10, "slices": 5, ...}' python experiments/ipmsa-classifier/train_torch.py
"""

import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from diffusion_classifier_tpu_torch.experiments.ipmsa_classifier import train_main  # noqa: E402


def main(argv=None):
    """Trains for the config's epochs; returns the engine."""
    return train_main(argv, description=__doc__.splitlines()[0])


if __name__ == "__main__":
    main()
