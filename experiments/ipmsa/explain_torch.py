"""IPMSA counterfactual explanation on the PyTorch/CUDA port (mirrors explain.py).

For each forced label, active then inactive: the test split with every
prompt set to that label, each real image re-noised to t = 0.5 and sampled
back under the forced condition (CFG, the config's ``sampling_steps`` over
[0.5, 0]), the samples handed to the IPMSA plotter — what this brain would
look like were the patient (in)active. Reads ``INFERENCE_CONFIG`` and the
torch checkpoint as inference_torch.py. Imports only the port;
``--device`` picks the torch device (default ``cuda``).

    DATA_PATH=/data/ipmsa INFERENCE_CONFIG='{"data_path": "volumes", ...}' \\
        python experiments/ipmsa/explain_torch.py
"""

import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from diffusion_classifier_tpu_torch.experiments.ipmsa import build_engine, explain_main  # noqa: E402


def main(argv=None, plot_function=None):
    """Returns ``{True: (samples, batches), False: (samples, batches)}``, keyed by the forced label."""
    return explain_main(build_engine, argv, plot_function, description=__doc__.splitlines()[0])


if __name__ == "__main__":
    main()
