"""CheXpert DiT inference on the PyTorch/CUDA port (mirrors inference.py).

Reads the same ``INFERENCE_CONFIG`` JSON and loads the torch checkpoint
from ``<project_root>/<experiment_dir>/<checkpoint_folder>/``. With
``classification=true`` it prints the classification metrics; otherwise it
samples one image per test image (CFG, the config's ``sampling_steps``)
and hands them to the CheXpert plotter (inverse DWT, one figure per batch).
Imports only the port; ``--device`` picks the torch device (default
``cuda``).

    INFERENCE_CONFIG='{"data_path": "synthetic", "image_size": 256, ...}' \\
        python experiments/chexpert-dit/inference_torch.py
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
    """Returns ``(metric_output, predictions, batches)``, or ``(samples, batches)`` when sampling.

    ``plot_function`` defaults to the CheXpert plotter.
    """
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    config = ExperimentConfig.from_env("INFERENCE_CONFIG")
    data = build_data(config)
    engine = build_engine(config, device=args.device)
    if not config.classification:
        return engine.inference(
            val_dataloader=data.get_test_loader(),
            plot_function=plot_function or make_chexpert_plotter(config),
            classification=False,
            checkpoint_folder=config.checkpoint_folder,
        )
    metrics = [Accuracy("accuracy"), F1("f1"), Precision("precision"), Recall("recall")]
    metric_output, val_samples, batches = engine.inference(
        val_dataloader=data.get_test_loader(),
        metrics=metrics,
        classification=True,
        checkpoint_folder=config.checkpoint_folder,
    )
    print([{k: round(v, 4) for k, v in d.items()} for d in metric_output])
    return metric_output, val_samples, batches


if __name__ == "__main__":
    main()
