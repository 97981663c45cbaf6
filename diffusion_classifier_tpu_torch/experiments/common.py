"""What the diffusion experiments' entry points share: their arguments, metrics and bodies.

Each family passes its own ``build_engine``, ``build_data`` and default
plotter (``default_plotter(config)`` returns the plot function):
:mod:`.chexpert_common` for the CheXpert DiT and UNet, :mod:`.ipmsa` for the
IPMSA UNet and DiT. :mod:`.ipmsa_classifier` takes the arguments and the
metrics.

- :func:`train_main` trains through ``DiffusionClassifier.train_loop`` with
  the four classification metrics, keeping the best checkpoint by F1;
- :func:`inference_main` classifies the test split with those metrics, or
  samples (CFG) and plots when ``classification`` is false.

Each takes ``--device`` (default ``cuda``) and reads its config from the
environment, as the JAX scripts do. Launched by ``torchrun
--nproc_per_node=N``, each process first joins the process group
(:func:`device_of`: ``parallel.mesh.init_distributed``) and drives
``cuda:LOCAL_RANK`` (``--device cpu``: the CPU over gloo); the engine
places its state by the config's ``param_sharding``, and only rank 0
prints, plots and writes files.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

from ..engine import DiffusionClassifier
from ..parallel.mesh import init_distributed, is_main_process
from ..utils.config import ExperimentConfig
from ..utils.metrics import F1, Accuracy, Precision, Recall

__all__ = ["device_of", "inference_main", "metrics", "parser", "train_main"]

BuildEngine = Callable[..., DiffusionClassifier]


def metrics():
    return [Accuracy("accuracy"), F1("f1"), Precision("precision"), Recall("recall")]


def parser(description: str) -> argparse.ArgumentParser:
    """The entry points' arguments: ``--device`` (default ``cuda``)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda")
    return p


def device_of(args) -> torch.device:
    """``--device``; under a multi-process launch this rank's, once it has joined the group."""
    return init_distributed(args.device)


def train_main(build_engine: BuildEngine, build_data: Callable, default_plotter: Callable,
               argv=None, plot_function=None, description=None):
    """Trains for ``TRAINING_CONFIG``'s epochs; returns the engine. ``plot_function=None`` takes ``default_plotter(config)``."""
    args = parser(description).parse_args(argv)
    config = ExperimentConfig.from_env("TRAINING_CONFIG")
    data = build_data(config)
    engine = build_engine(config, device=device_of(args))
    engine.train_loop(
        train_dataloader=data.get_train_loader(),
        val_dataloader=data.get_val_loader(),
        metrics=metrics(),
        checkpoint_metric="f1",
        plot_function=plot_function or default_plotter(config),
    )
    return engine


def inference_main(build_engine: BuildEngine, build_data: Callable, default_plotter: Callable,
                   argv=None, plot_function=None, description=None,
                   on_predictions: Optional[Callable] = None):
    """Returns ``(metric_output, predictions, batches)``, or ``(samples, batches)`` when sampling.

    The samples go to ``plot_function`` (default ``default_plotter(config)``);
    after a classification ``on_predictions(config, data, predictions)``
    runs, if given.
    """
    args = parser(description).parse_args(argv)
    config = ExperimentConfig.from_env("INFERENCE_CONFIG")
    data = build_data(config)
    engine = build_engine(config, device=device_of(args))
    if not config.classification:
        return engine.inference(
            val_dataloader=data.get_test_loader(),
            plot_function=plot_function or default_plotter(config),
            classification=False,
            checkpoint_folder=config.checkpoint_folder,
        )
    metric_output, predictions, batches = engine.inference(
        val_dataloader=data.get_test_loader(),
        metrics=metrics(),
        classification=True,
        checkpoint_folder=config.checkpoint_folder,
    )
    if is_main_process():
        print([{k: round(v, 4) for k, v in d.items()} for d in metric_output])
    if on_predictions is not None:
        on_predictions(config, data, predictions)
    return metric_output, predictions, batches
