"""IPMSA DiT inference on the PyTorch/CUDA port (mirrors inference.py; the training architecture).

Reads the same ``INFERENCE_CONFIG`` JSON and loads the torch checkpoint
from ``<project_root>/<experiment_dir>/<checkpoint_folder>/``; prints the
four classification metrics over the test split, or samples and plots when
``classification`` is false. Imports only the port; ``--device`` picks the
torch device (default ``cuda``).

    DATA_PATH=/data/ipmsa INFERENCE_CONFIG='{"data_path": "volumes", "encoder_type": "DiT", ...}' \\
        python experiments/ipmsa-dit/inference_torch.py
"""

import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from diffusion_classifier_tpu_torch.experiments.common import inference_main  # noqa: E402
from diffusion_classifier_tpu_torch.experiments.ipmsa_dit import build_data, build_engine  # noqa: E402
from diffusion_classifier_tpu_torch.utils.plotters import make_ipmsa_plotter  # noqa: E402


def main(argv=None, plot_function=None):
    """Returns ``(metric_output, predictions, batches)``, or ``(samples, batches)`` when sampling."""
    return inference_main(build_engine, build_data, make_ipmsa_plotter, argv, plot_function,
                          description=__doc__.splitlines()[0])


if __name__ == "__main__":
    main()
