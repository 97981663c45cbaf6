"""IPMSA DiT training on the PyTorch/CUDA port (mirrors train.py).

Reads the same ``TRAINING_CONFIG`` JSON (``encoder_type "DiT"``) and trains
the 384-wide, 12-layer DiT through ``DiffusionClassifier.train_loop`` with
the four classification metrics, keeping the best checkpoint by F1; the
samples of each eval go to ``plot_function`` (default: the IPMSA
plotter). The data is the IPMSA experiment's. Imports only the port;
``--device`` picks the torch device (default ``cuda``).

    DATA_PATH=/data/ipmsa TRAINING_CONFIG='{"data_path": "volumes", "encoder_type": "DiT",
        "patch_size": 4, ...}' python experiments/ipmsa-dit/train_torch.py
"""

import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from diffusion_classifier_tpu_torch.experiments.common import train_main  # noqa: E402
from diffusion_classifier_tpu_torch.experiments.ipmsa_dit import build_data, build_engine  # noqa: E402
from diffusion_classifier_tpu_torch.utils.plotters import make_ipmsa_plotter  # noqa: E402


def main(argv=None, plot_function=None):
    """Trains for the config's epochs; returns the engine. ``plot_function=None`` takes the IPMSA plotter."""
    return train_main(build_engine, build_data, make_ipmsa_plotter, argv, plot_function,
                      description=__doc__.splitlines()[0])


if __name__ == "__main__":
    main()
