"""CheXpert UNet inference on the PyTorch/CUDA port (mirrors inference.py).

Reads the same ``INFERENCE_CONFIG`` JSON and loads the torch checkpoint
from ``<project_root>/<experiment_dir>/<checkpoint_folder>/``. With
``classification=true`` it prints the classification metrics and writes the
misclassified test images' paths to
``<experiment>/mistakes-ddpm-chexpert.txt``; otherwise it
samples one image per test image (CFG, the config's ``sampling_steps``)
and hands them to the CheXpert plotter (inverse DWT, one figure per batch).
Imports only the port; ``--device`` picks the torch device (default
``cuda``).

    INFERENCE_CONFIG='{"data_path": "/data/CheXpert-v1.0-small", "image_size": 256,
                       "wavelet_transform": true, "classes": 2, ...}' \\
        python experiments/chexpert-unet/inference_torch.py
"""

import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from diffusion_classifier_tpu_torch.experiments.chexpert_unet import build_data, build_engine, write_mistakes  # noqa: E402
from diffusion_classifier_tpu_torch.experiments.common import inference_main  # noqa: E402
from diffusion_classifier_tpu_torch.utils.plotters import make_chexpert_plotter  # noqa: E402


def main(argv=None, plot_function=None):
    """Returns ``(metric_output, predictions, batches)``, or ``(samples, batches)`` when sampling.

    ``plot_function`` defaults to the CheXpert plotter.
    """
    return inference_main(build_engine, build_data, make_chexpert_plotter, argv, plot_function,
                          description=__doc__.splitlines()[0], on_predictions=write_mistakes)


if __name__ == "__main__":
    main()
