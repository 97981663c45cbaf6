"""CheXpert DiT training on the PyTorch/CUDA port (mirrors train.py).

Reads the same ``TRAINING_CONFIG`` JSON, trains through
``DiffusionClassifier.train_loop`` with the four classification metrics and
keeps the best checkpoint by F1. At each eval the samples go to
``plot_function``, by default ``make_chexpert_plotter(config)`` (one PNG per
val batch, the DWT inverted), as in train.py. Imports only the port;
``--device`` picks the torch device (default ``cuda``). Synthetic data only
(``data_path "synthetic"``).

    TRAINING_CONFIG='{"data_path": "synthetic", "image_size": 256, ...}' \\
        python experiments/chexpert-dit/train_torch.py
"""

import argparse
import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from diffusion_classifier_tpu_torch.experiments.chexpert_dit import (  # noqa: E402
    build_data,
    build_engine,
)
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig  # noqa: E402
from diffusion_classifier_tpu_torch.utils.metrics import (  # noqa: E402
    F1,
    Accuracy,
    Precision,
    Recall,
)
from diffusion_classifier_tpu_torch.utils.plotters import make_chexpert_plotter  # noqa: E402


def main(argv=None, plot_function=None):
    """Trains for the config's epochs; returns the engine. ``plot_function=None`` takes the CheXpert plotter."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    config = ExperimentConfig.from_env("TRAINING_CONFIG")
    if plot_function is None:
        plot_function = make_chexpert_plotter(config)
    data = build_data(config)
    engine = build_engine(config, device=args.device)
    engine.train_loop(
        train_dataloader=data.get_train_loader(),
        val_dataloader=data.get_val_loader(),
        metrics=[Accuracy("accuracy"), F1("f1"), Precision("precision"), Recall("recall")],
        checkpoint_metric="f1",
        plot_function=plot_function,
    )
    return engine


if __name__ == "__main__":
    main()
