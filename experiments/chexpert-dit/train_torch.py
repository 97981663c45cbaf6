"""CheXpert DiT training on the PyTorch/CUDA port (mirrors train.py).

Reads the same ``TRAINING_CONFIG`` JSON, trains through
``DiffusionClassifier.train_loop`` with the four classification metrics and
keeps the best checkpoint by F1. At each eval the samples go to
``plot_function``, by default ``make_chexpert_plotter(config)`` (one PNG per
val batch, the DWT inverted), as in train.py. Imports only the port;
``--device`` picks the torch device (default ``cuda``). ``data_path`` is a
CheXpert tree (``train.csv`` and its JPEGs) or ``"synthetic"``.

    TRAINING_CONFIG='{"data_path": "synthetic", "image_size": 256, ...}' \\
        python experiments/chexpert-dit/train_torch.py
"""

import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from diffusion_classifier_tpu_torch.experiments.chexpert_dit import build_data, build_engine  # noqa: E402
from diffusion_classifier_tpu_torch.experiments.common import train_main  # noqa: E402
from diffusion_classifier_tpu_torch.utils.plotters import make_chexpert_plotter  # noqa: E402


def main(argv=None, plot_function=None):
    """Trains for the config's epochs; returns the engine. ``plot_function=None`` takes the CheXpert plotter."""
    return train_main(build_engine, build_data, make_chexpert_plotter, argv, plot_function,
                      description=__doc__.splitlines()[0])


if __name__ == "__main__":
    main()
