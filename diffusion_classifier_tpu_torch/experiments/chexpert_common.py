"""What the two CheXpert experiments share: the data, the mistakes file and the OOD entry point.

Both families (:mod:`.chexpert_dit`, :mod:`.chexpert_unet`) read the same
data — a CheXpert tree (``train.csv`` and its JPEGs) or the synthetic set —
through :func:`build_data`. Their train and inference scripts run
:mod:`.common`'s bodies with it and ``make_chexpert_plotter``; inference
writes the mistakes file (:func:`write_mistakes`). :func:`ood_main`
classifies the OOD set that ``--dataset`` names.

Each takes ``--device`` (default ``cuda``) and reads its config from the
environment, as the JAX scripts do.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.chexpert import CheXpertDataLoader
from ..data.ood import OOD_DATASETS, make_ood_loader
from ..data.synthetic import SyntheticDataLoader
from ..parallel.mesh import data_position, is_main_process
from ..utils.config import ExperimentConfig
from .common import BuildEngine, device_of, metrics, parser

__all__ = ["build_data", "ood_main", "write_mistakes"]


def build_data(config: ExperimentConfig):
    if config.data_path == "synthetic":
        return SyntheticDataLoader(
            256, 64,
            batch_size=config.batch_size,
            image_size=config.image_size,
            channels=config.image_channels,
            classes=config.classes,
            seed=config.seed,
        )
    return CheXpertDataLoader(
        wavelet_transform=config.wavelet_transform,
        data_path=config.data_path,
        batch_size=config.batch_size,
        num_workers=config.num_workers,
        image_size=config.image_size,
        seed=config.seed,
        fast_decode=config.fast_decode,
        decode_cache_dir=config.decode_cache_dir,
    )


def write_mistakes(config: ExperimentConfig, data, predictions) -> str | None:
    """Write ``mistakes-ddpm-chexpert.txt``: the test split's misclassified paths, one a line.

    ``predictions`` are the inference's per-batch predictions, in the test
    loader's order (drop_last batching: the file covers the first
    ``len(predictions)`` items). Under several processes each holds its
    rows of every batch: the predictions are gathered (a collective) and
    rank 0 alone writes. Returns the path, or None where nothing was
    written (another rank, or a data set without paths).
    """
    dataset = getattr(data, "test_dataset", None)
    if not hasattr(dataset, "mistake_paths"):
        return None
    predictions = [np.asarray(p) for p in predictions]
    index, count = data_position()
    if count > 1:
        import torch.distributed as dist

        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, (index, predictions))
        by_index = dict(gathered)  # the ranks of one model group hold the same rows
        predictions = [
            np.concatenate([by_index[i][b] for i in range(count)]) for b in range(len(predictions))
        ]
    if not is_main_process():
        return None
    preds = np.concatenate(predictions)
    mistakes = dataset.mistake_paths(preds)
    out = os.path.join(config.experiment_path, "mistakes-ddpm-chexpert.txt")
    os.makedirs(config.experiment_path, exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(mistakes) + "\n")
    print(f"{len(mistakes)} mistakes written to {out}")
    return out


def ood_main(build_engine: BuildEngine, argv=None, description=None):
    """Classifies the OOD set ``--dataset`` names (default: the config's ``ood_dataset``).

    Returns ``(metric_output, predictions, batches)``.
    """
    config = ExperimentConfig.from_env("INFERENCE_CONFIG")
    p = parser(description)
    p.add_argument("--dataset", choices=OOD_DATASETS, default=config.ood_dataset,
                   help="OOD data set (default: the config's ood_dataset)")
    args = p.parse_args(argv)
    loader = make_ood_loader(args.dataset, config)
    engine = build_engine(config, device=device_of(args))
    metric_output, predictions, batches = engine.inference(
        val_dataloader=loader,
        metrics=metrics(),
        classification=config.classification,
        checkpoint_folder=config.checkpoint_folder,
    )
    if is_main_process():
        print(args.dataset, [{k: round(v, 4) for k, v in d.items()} for d in metric_output])
    return metric_output, predictions, batches
