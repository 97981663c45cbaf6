"""CheXpert DiT training on the PyTorch/CUDA port (mirrors train.py).

Reads the same ``TRAINING_CONFIG`` JSON, trains through
``DiffusionClassifier.train_loop`` with the four classification metrics and
keeps the best checkpoint by F1. Imports only the port; ``--device`` picks
the torch device (default ``cuda``). Synthetic data only (``data_path
"synthetic"``). ``plot_function`` is None: the sample plots need the
sampler, which is not ported yet (ROADMAP A7), so the sampling pass that
feeds them is skipped.

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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    config = ExperimentConfig.from_env("TRAINING_CONFIG")
    data = build_data(config)
    engine = build_engine(config, device=args.device)
    engine.train_loop(
        train_dataloader=data.get_train_loader(),
        val_dataloader=data.get_val_loader(),
        metrics=[Accuracy("accuracy"), F1("f1"), Precision("precision"), Recall("recall")],
        checkpoint_metric="f1",
        plot_function=None,
    )
    return engine


if __name__ == "__main__":
    main()
