"""CIFAR-10 training on the PyTorch/CUDA port (mirrors train.py).

Reads the same ``TRAINING_CONFIG`` JSON and trains the flagship UNet through
``DiffusionClassifier.train_loop``, with classification accuracy as the
metric that picks the best checkpoint. ``data_path`` is a CIFAR-10 download
(the ``cifar-10-batches-py`` pickles or their tarball) or ``"synthetic"``.
At each eval the samples go to ``plot_function`` (``cifar_plotter``: a PNG
of the first sample). Imports only the port; ``--device`` picks the torch
device (default ``cuda``).

    TRAINING_CONFIG='{"data_path": "synthetic", "batch_size": 64, ...}' \\
        python experiments/cifar10/train_torch.py
"""

import argparse
import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from diffusion_classifier_tpu_torch.experiments.cifar10 import (  # noqa: E402
    build_data,
    build_engine,
)
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig  # noqa: E402
from diffusion_classifier_tpu_torch.utils.metrics import Accuracy  # noqa: E402
from diffusion_classifier_tpu_torch.utils.plotters import cifar_plotter  # noqa: E402


def main(argv=None, plot_function=cifar_plotter):
    """Trains for the config's epochs; returns the engine."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    config = ExperimentConfig.from_env("TRAINING_CONFIG")
    data = build_data(config)
    engine = build_engine(config, device=args.device)
    engine.train_loop(
        train_dataloader=data.get_train_loader(),
        val_dataloader=data.get_test_loader(),
        metrics=[Accuracy("classification accuracy")],
        checkpoint_metric="classification accuracy",
        plot_function=plot_function,
    )
    return engine


if __name__ == "__main__":
    main()
