"""The port's CIFAR-10 loader against the JAX package's, and the CIFAR training entry point.

The tests write ``cifar-10-batches-py`` pickle files in the on-disk format
(uint8 ``data`` rows of 3 × 32 × 32 channel-major bytes, byte-keyed dicts),
as ``tests/test_cifar_loader.py`` does, and hand the same folder to both
loaders. ``experiments/cifar10/train_torch.py`` then trains on such files on
the CPU: a few 32 px images, one step of the flagship's architecture at a
quarter of its width (the full width's 95.9 M parameters are held to JAX in
``tests/test_torch_unet.py``; here the wiring is under test).
"""

import dataclasses
import importlib.util
import json
import os
import tarfile

import numpy as np
import pytest
import torch

from _torch_parity import write_cifar_batches
from diffusion_classifier_tpu.data.cifar import CIFAR10DataLoader as JaxCIFAR10DataLoader
from diffusion_classifier_tpu.data.cifar import load_cifar10_arrays as jax_load_cifar10_arrays
from diffusion_classifier_tpu_torch.data.cifar import (
    CIFAR10_CLASSES,
    CIFAR10DataLoader,
    load_cifar10_arrays,
)
from diffusion_classifier_tpu_torch.experiments import cifar10
from diffusion_classifier_tpu_torch.experiments.cifar10 import build_data
from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("layout", ["folder", "tarball"])
def test_cifar_arrays_and_batches_match_jax(tmp_path, layout):
    write_cifar_batches(tmp_path / "files" / "cifar-10-batches-py", n_train=8, n_test=8)
    path = str(tmp_path / "files")
    if layout == "tarball":
        path = str(tmp_path / "tar_only")
        os.mkdir(path)
        with tarfile.open(os.path.join(path, "cifar-10-python.tar.gz"), "w:gz") as tf:
            tf.add(tmp_path / "files" / "cifar-10-batches-py", arcname="cifar-10-batches-py")
    got = load_cifar10_arrays(path)  # the port extracts the tarball first
    assert os.path.isfile(os.path.join(path, "cifar-10-batches-py", "test_batch"))
    for a, b in zip(got, jax_load_cifar10_arrays(path), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (40, 32, 32, 3) and -1.0 <= got[0].min() and got[0].max() <= 1.0
    port, ref = CIFAR10DataLoader(path, 4, seed=5), JaxCIFAR10DataLoader(path, 4, seed=5)
    for get in ("get_train_loader", "get_test_loader"):
        # the first two batches: the train split shuffled by the seed, the test in file order
        for a, b in zip(list(getattr(port, get)())[:2], list(getattr(ref, get)())[:2], strict=True):
            assert a["images"].dtype == np.float32 and a["prompt"].dtype == np.int32
            np.testing.assert_array_equal(a["images"], b["images"])
            np.testing.assert_array_equal(a["prompt"], b["prompt"])
    assert len(CIFAR10_CLASSES) == 10


def test_missing_cifar_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="cannot download"):
        load_cifar10_arrays(str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        build_data(ExperimentConfig(data_path=str(tmp_path / "nope")))


_FULL_WIDTH = cifar10.build_backbone


def _narrow_flagship(config):
    """The experiment's UNet with every width divided by 4: the same levels, blocks and heads."""
    with torch.device("meta"):
        cfg = _FULL_WIDTH(config).config
    narrow = dataclasses.replace(
        cfg, block_out_channels=tuple(c // 4 for c in cfg.block_out_channels),
        encoder_hid_dim=cfg.encoder_hid_dim // 4, cross_attention_dim=cfg.cross_attention_dim // 4,
        norm_num_groups=8,
    )
    return UNetCondition2D(narrow, torch.float32)


def test_train_torch_runs_on_cpu(tmp_path, monkeypatch, capsys):
    # the flagship's architecture at a quarter of its width on 32 px
    # pickles: 5 train images make one step at B=5; 2 classes, one
    # evaluation, one sampling step for the plot keep the eval short
    monkeypatch.setattr(cifar10, "build_backbone", _narrow_flagship)
    write_cifar_batches(tmp_path / "data" / "cifar-10-batches-py", n_train=1, n_test=5, classes=2)
    config = dict(
        data_path=str(tmp_path / "data"), classes=2, encoder_type="nn", mixed_precision="no",
        batch_size=5, num_epochs=1, log_every_steps=1, evaluation_per_stage=[1],
        evaluation_batches=0, sampling_steps=1, use_comet=True,
        project_root=str(tmp_path), experiment_dir="exp",
    )
    monkeypatch.setenv("TRAINING_CONFIG", json.dumps(config))
    path = os.path.join(REPO, "experiments", "cifar10", "train_torch.py")
    spec = importlib.util.spec_from_file_location("cifar10_train_torch", path)
    train_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_torch)
    engine = train_torch.main(["--device", "cpu"])
    assert engine.state.step == 1
    assert engine.denoiser.backbone.config.block_out_channels == (32, 32, 64, 128)
    exp = tmp_path / "exp"
    events = [json.loads(line) for line in (exp / "track.jsonl").read_text().splitlines()]
    losses = [e["value"] for e in events if e.get("name") == "loss" and e.get("step") is not None]
    assert len(losses) == 1 and all(np.isfinite(losses))
    assert any(e.get("name") == "val_classification accuracy" for e in events)
    for name in ("ema_params.pt", "train_state.pt", "experiment_state.json"):
        assert (exp / "checkpoints" / name).is_file()
    assert (exp / "training_images" / "sample_0_0.png").is_file()
    out = capsys.readouterr().out
    assert "step 1/1" in out and "Checkpoint saved" in out
