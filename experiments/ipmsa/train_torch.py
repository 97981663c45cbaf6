"""IPMSA UNet training on the PyTorch/CUDA port (mirrors train.py).

Reads the same ``TRAINING_CONFIG`` JSON and trains the 5-level IPMSA UNet
through ``DiffusionClassifier.train_loop`` with the four classification
metrics, keeping the best checkpoint by F1. At each eval the samples go to
``plot_function``, by default ``make_ipmsa_plotter(config)`` (the centre
FLAIR slice with the CT2F lesion overlay). ``data_path`` is ``"synthetic"``
or anything else for the MRI volumes: the split pickles under
``<experiment>/split/`` over the volumes at ``$DATA_PATH``. Imports only
the port; ``--device`` picks the torch device (default ``cuda``).

    DATA_PATH=/data/ipmsa TRAINING_CONFIG='{"data_path": "volumes", "image_size": 256,
        "image_channels": 10, "slices": 5, "wavelet_transform": true, "classes": 2, ...}' \\
        python experiments/ipmsa/train_torch.py
"""

import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from diffusion_classifier_tpu_torch.experiments.common import train_main  # noqa: E402
from diffusion_classifier_tpu_torch.experiments.ipmsa import build_data, build_engine  # noqa: E402
from diffusion_classifier_tpu_torch.utils.plotters import make_ipmsa_plotter  # noqa: E402


def main(argv=None, plot_function=None):
    """Trains for the config's epochs; returns the engine. ``plot_function=None`` takes the IPMSA plotter."""
    return train_main(build_engine, build_data, make_ipmsa_plotter, argv, plot_function,
                      description=__doc__.splitlines()[0])


if __name__ == "__main__":
    main()
