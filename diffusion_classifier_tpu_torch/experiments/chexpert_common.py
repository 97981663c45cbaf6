"""What the two CheXpert experiments share: the data, the mistakes file and the entry points.

Both families (:mod:`.chexpert_dit`, :mod:`.chexpert_unet`) read the same
data — a CheXpert tree (``train.csv`` and its JPEGs) or the synthetic set —
and run the same three scripts, which differ only in ``build_engine``:

- :func:`train_main` trains through ``DiffusionClassifier.train_loop`` with
  the four classification metrics, keeping the best checkpoint by F1;
- :func:`inference_main` classifies the test split and writes the mistakes
  file, or samples (CFG) and plots when ``classification`` is false;
- :func:`ood_main` classifies the OOD set that ``--dataset`` names.

Each takes ``--device`` (default ``cuda``) and reads its config from the
environment, as the JAX scripts do.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

import numpy as np

from ..data.chexpert import CheXpertDataLoader
from ..data.ood import OOD_DATASETS, make_ood_loader
from ..data.synthetic import SyntheticDataLoader
from ..engine import DiffusionClassifier
from ..utils.config import ExperimentConfig
from ..utils.metrics import F1, Accuracy, Precision, Recall
from ..utils.plotters import make_chexpert_plotter

__all__ = ["build_data", "inference_main", "ood_main", "train_main", "write_mistakes"]

BuildEngine = Callable[..., DiffusionClassifier]


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
    ``len(predictions)`` items). Only a single process writes it, since
    under several each holds its own rows of every batch; returns the path,
    or None where nothing was written (several processes, or a data set
    without paths).
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return None
    dataset = getattr(data, "test_dataset", None)
    if not hasattr(dataset, "mistake_paths"):
        return None
    preds = np.concatenate([np.asarray(p) for p in predictions])
    mistakes = dataset.mistake_paths(preds)
    out = os.path.join(config.experiment_path, "mistakes-ddpm-chexpert.txt")
    os.makedirs(config.experiment_path, exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(mistakes) + "\n")
    print(f"{len(mistakes)} mistakes written to {out}")
    return out


def _metrics():
    return [Accuracy("accuracy"), F1("f1"), Precision("precision"), Recall("recall")]


def _parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda")
    return parser


def train_main(build_engine: BuildEngine, argv=None, plot_function=None, description=None):
    """Trains for ``TRAINING_CONFIG``'s epochs; returns the engine. ``plot_function=None`` takes the CheXpert plotter."""
    args = _parser(description).parse_args(argv)
    config = ExperimentConfig.from_env("TRAINING_CONFIG")
    if plot_function is None:
        plot_function = make_chexpert_plotter(config)
    data = build_data(config)
    engine = build_engine(config, device=args.device)
    engine.train_loop(
        train_dataloader=data.get_train_loader(),
        val_dataloader=data.get_val_loader(),
        metrics=_metrics(),
        checkpoint_metric="f1",
        plot_function=plot_function,
    )
    return engine


def inference_main(build_engine: BuildEngine, argv=None, plot_function=None, description=None):
    """Returns ``(metric_output, predictions, batches)``, or ``(samples, batches)`` when sampling.

    ``plot_function`` defaults to the CheXpert plotter.
    """
    args = _parser(description).parse_args(argv)
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
    metric_output, val_samples, batches = engine.inference(
        val_dataloader=data.get_test_loader(),
        metrics=_metrics(),
        classification=True,
        checkpoint_folder=config.checkpoint_folder,
    )
    print([{k: round(v, 4) for k, v in d.items()} for d in metric_output])
    write_mistakes(config, data, val_samples)
    return metric_output, val_samples, batches


def ood_main(build_engine: BuildEngine, argv=None, description=None):
    """Classifies the OOD set ``--dataset`` names (default: the config's ``ood_dataset``).

    Returns ``(metric_output, predictions, batches)``.
    """
    config = ExperimentConfig.from_env("INFERENCE_CONFIG")
    parser = _parser(description)
    parser.add_argument("--dataset", choices=OOD_DATASETS, default=config.ood_dataset,
                        help="OOD data set (default: the config's ood_dataset)")
    args = parser.parse_args(argv)
    loader = make_ood_loader(args.dataset, config)
    engine = build_engine(config, device=args.device)
    metric_output, predictions, batches = engine.inference(
        val_dataloader=loader,
        metrics=_metrics(),
        classification=config.classification,
        checkpoint_folder=config.checkpoint_folder,
    )
    print(args.dataset, [{k: round(v, 4) for k, v in d.items()} for d in metric_output])
    return metric_output, predictions, batches
