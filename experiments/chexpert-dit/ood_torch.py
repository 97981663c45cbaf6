"""Out-of-distribution evaluation of the CheXpert DiT on the PyTorch/CUDA port (mirrors ood.py).

Reads the same ``INFERENCE_CONFIG`` JSON, loads the torch checkpoint from
``<project_root>/<experiment_dir>/<checkpoint_folder>/`` and classifies the
OOD set that ``--dataset {mimic,padchest,isic}`` names (default: the
config's ``ood_dataset``), printing the four classification metrics.
MIMIC and PadChest are read at 64 px, ISIC at 256 px over its test split
(``data/ood.py``); ``data_path`` is the OOD set's folder, or
``"synthetic"``. Imports only the port; ``--device`` picks the torch device
(default ``cuda``).

    INFERENCE_CONFIG='{"data_path": "/data/mimic", "image_size": 256, ...}' \\
        python experiments/chexpert-dit/ood_torch.py --dataset mimic
"""

import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from diffusion_classifier_tpu_torch.experiments.chexpert_common import ood_main  # noqa: E402
from diffusion_classifier_tpu_torch.experiments.chexpert_dit import build_engine  # noqa: E402


def main(argv=None):
    """Returns ``(metric_output, predictions, batches)``."""
    return ood_main(build_engine, argv, description=__doc__.splitlines()[0])


if __name__ == "__main__":
    main()
