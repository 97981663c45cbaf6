"""IPMSA ResNet baseline inference on the PyTorch/CUDA port (mirrors inference.py).

Reads the same ``INFERENCE_CONFIG`` JSON, loads the checkpoint from
``<project_root>/<experiment_dir>/<checkpoint_folder>/`` and prints the
test split's mean cross-entropy and four classification metrics. Imports
only the port; ``--device`` picks the torch device (default ``cuda``).

    DATA_PATH=/data/ipmsa INFERENCE_CONFIG='{"data_path": "volumes", "variant": "resnet50", ...}' \\
        python experiments/ipmsa-classifier/inference_torch.py
"""

import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from diffusion_classifier_tpu_torch.experiments.ipmsa_classifier import inference_main  # noqa: E402


def main(argv=None):
    """Returns ``(val_loss, metric_output)``."""
    return inference_main(argv, description=__doc__.splitlines()[0])


if __name__ == "__main__":
    main()
