"""The IPMSA discriminative baseline — port of ``experiments/ipmsa-classifier/{common,train,inference}.py``.

A ResNet (``variant``: resnet18/34/50; ``pretrained`` and
``pretrained_path`` from the config) and a linear head on the IPMSA task and
transform, trained with cross-entropy (:class:`..engine.classifier.Classifier`).
The data is :mod:`.ipmsa`'s, without the counterfactual label.

- :func:`train_main` trains with the four classification metrics and
  saves at each eval (every ``eval_period`` epochs);
- :func:`inference_main` loads the checkpoint and returns the test split's
  mean cross-entropy and metrics.
"""

from __future__ import annotations

from ..engine.classifier import Classifier
from ..models.resnet import ResNet2D
from ..utils.config import ExperimentConfig
from ..parallel.mesh import is_main_process
from .common import device_of, metrics, parser
from .ipmsa import build_data

__all__ = ["build_data", "build_engine", "inference_main", "train_main"]


def build_engine(config: ExperimentConfig, device="cuda") -> Classifier:
    backbone = ResNet2D(
        variant=config.variant,
        pretrained=config.pretrained,
        pretrained_path=config.pretrained_path or "",
        in_channels=config.image_channels,
    )
    return Classifier(backbone, config, device=device)


def train_main(argv=None, description=None) -> Classifier:
    """Trains for ``TRAINING_CONFIG``'s epochs; returns the engine."""
    args = parser(description).parse_args(argv)
    config = ExperimentConfig.from_env("TRAINING_CONFIG")
    data = build_data(config)
    engine = build_engine(config, device=device_of(args))
    engine.train_loop(
        train_dataloader=data.get_train_loader(),
        val_dataloader=data.get_val_loader(),
        metrics=metrics(),
    )
    return engine


def inference_main(argv=None, description=None):
    """Returns ``(val_loss, metric_output)`` over the test split."""
    args = parser(description).parse_args(argv)
    config = ExperimentConfig.from_env("INFERENCE_CONFIG")
    data = build_data(config)
    engine = build_engine(config, device=device_of(args))
    val_loss, metric_output = engine.inference(
        val_dataloader=data.get_test_loader(), metrics=metrics()
    )
    if is_main_process():
        print(f"val_loss: {val_loss:.4f}")
        print([{k: round(v, 4) for k, v in d.items()} for d in metric_output])
    return val_loss, metric_output
