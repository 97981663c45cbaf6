"""IPMSA UNet inference on the PyTorch/CUDA port (mirrors inference.py).

Reads the same ``INFERENCE_CONFIG`` JSON and loads the torch checkpoint
from ``<project_root>/<experiment_dir>/<checkpoint_folder>/``. With
``classification=true`` it prints the four classification metrics over the
test split; otherwise it samples one image per test image (CFG, the
config's ``sampling_steps``) and hands them to the IPMSA plotter. Imports
only the port; ``--device`` picks the torch device (default ``cuda``).

    DATA_PATH=/data/ipmsa INFERENCE_CONFIG='{"data_path": "volumes", ...}' \\
        python experiments/ipmsa/inference_torch.py
"""

import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from diffusion_classifier_tpu_torch.experiments.common import inference_main  # noqa: E402
from diffusion_classifier_tpu_torch.experiments.ipmsa import build_data, build_engine  # noqa: E402
from diffusion_classifier_tpu_torch.utils.plotters import make_ipmsa_plotter  # noqa: E402


def main(argv=None, plot_function=None):
    """Returns ``(metric_output, predictions, batches)``, or ``(samples, batches)`` when sampling."""
    return inference_main(build_engine, build_data, make_ipmsa_plotter, argv, plot_function,
                          description=__doc__.splitlines()[0])


if __name__ == "__main__":
    main()
