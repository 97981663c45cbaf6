"""CIFAR-10 inference on the PyTorch/CUDA port (mirrors inference.py).

Reads the same ``INFERENCE_CONFIG`` JSON and loads the torch checkpoint
from ``<project_root>/<experiment_dir>/<checkpoint_folder>/``. With
``classification=true`` it prints the accuracy over the test set; otherwise
it samples one image per test image (CFG, the config's ``sampling_steps``)
and hands the samples to the plotter (``cifar_plotter``: a PNG of the first
sample). Imports only the port; ``--device`` picks the torch device
(default ``cuda``).

    INFERENCE_CONFIG='{"data_path": "synthetic", "classification": true, ...}' \\
        python experiments/cifar10/inference_torch.py
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
    """Returns ``(metric_output, predictions, batches)``, or ``(samples, batches)`` when sampling."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    config = ExperimentConfig.from_env("INFERENCE_CONFIG")
    data = build_data(config)
    engine = build_engine(config, device=args.device)
    result = engine.inference(
        val_dataloader=data.get_test_loader(),
        metrics=[Accuracy("classification accuracy")] if config.classification else None,
        plot_function=plot_function,
        classification=config.classification,
        checkpoint_folder=config.checkpoint_folder,
    )
    if config.classification:
        print(result[0])
    return result


if __name__ == "__main__":
    main()
