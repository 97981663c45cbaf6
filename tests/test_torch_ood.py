"""The port's out-of-distribution loaders and OOD entry points against the JAX package's.

1. ``make_ood_loader`` for MIMIC (64 px JPEGs, kept in [0, 1]), PadChest
   (16-bit grey PNGs, bicubic, scaled by 255·255) and ISIC (256 px JPEGs,
   the test split) on data-format trees written under ``tmp_path``: the
   batch contract and every value equal to the JAX loader's, at 0 and 2
   workers; ISIC's ``cf_label`` with ``original_labels``; the synthetic set.
2. ``experiments/chexpert-{unet,dit}/ood_torch.py`` ``main()`` on the CPU
   against a checkpoint laid out as training leaves it: the CheXpert UNet
   at a narrow width, the DiT-b4 at its full width (64 tokens at 64 px).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_same_batches,
    narrow_chexpert_unet,
    write_isic_tree,
    write_mimic_tree,
    write_padchest_tree,
)
from diffusion_classifier_tpu.data.isic import ISICDataLoader as JaxISICDataLoader
from diffusion_classifier_tpu.data.ood import make_ood_loader as jax_make_ood_loader
from diffusion_classifier_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from diffusion_classifier_tpu_torch.data.isic import ISICDataLoader
from diffusion_classifier_tpu_torch.data.ood import OOD_DATASETS, make_ood_loader
from diffusion_classifier_tpu_torch.experiments import chexpert_dit, chexpert_unet
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRITERS = {"mimic": write_mimic_tree, "padchest": write_padchest_tree, "isic": write_isic_tree}
# (image size, value range) of each set's batches; PadChest's 16-bit values
# over the reference's 255·255 reach 65535 / 65025 before the map to [-1, 1]
GEOMETRY = {"mimic": (64, (0.0, 1.0)), "padchest": (64, (-1.0, 2 * 65535 / 65025 - 1)),
            "isic": (256, (-1.0, 1.0))}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("name", OOD_DATASETS)
def test_ood_loader_matches_jax(tmp_path, name, workers):
    root = WRITERS[name](tmp_path / name)
    config = dict(data_path=root, batch_size=2, num_workers=workers, seed=4, image_size=256,
                  wavelet_transform=True, classes=2)
    port = make_ood_loader(name, ExperimentConfig(**config))
    ref = jax_make_ood_loader(name, JaxExperimentConfig(**config))
    batches = list(port)
    assert_same_batches(batches, ref)
    size, (low, high) = GEOMETRY[name]
    for batch in batches:
        assert sorted(batch) == ["images", "prompt"]
        assert batch["images"].shape == (2, size, size, 3) and batch["images"].dtype == np.float32
        assert batch["prompt"].dtype == np.int32 and set(batch["prompt"].tolist()) <= {0, 1}
        assert low <= batch["images"].min() and batch["images"].max() <= high
    if name == "padchest":  # grey, repeated to three channels
        np.testing.assert_array_equal(batches[0]["images"][..., 0], batches[0]["images"][..., 2])


def test_isic_cf_label_keeps_the_original_labels(tmp_path):
    root = write_isic_tree(tmp_path / "isic")
    kw = dict(cf_label=1, batch_size=2, num_workers=2, image_size=32, seed=5)
    port, ref = ISICDataLoader(True, root, **kw), JaxISICDataLoader(True, root, **kw)
    for get in ("get_train_loader", "get_val_loader", "get_test_loader"):
        batches = list(getattr(port, get)())
        assert_same_batches(batches, getattr(ref, get)())
    assert all((b["prompt"] == 1).all() and "original_labels" in b for b in batches)


def test_synthetic_ood_loader_matches_jax():
    config = dict(data_path="synthetic", batch_size=4, image_size=8, classes=2, seed=6)
    assert_same_batches(
        make_ood_loader("isic", ExperimentConfig(**config)),
        jax_make_ood_loader("isic", JaxExperimentConfig(**config)),
    )
    with pytest.raises(ValueError, match="unknown OOD dataset"):
        make_ood_loader("chexpert", ExperimentConfig(**config))


FAMILIES = {
    # family: (experiment module, config): the DiT at patch 4 sees 8 x 8 = 64
    # tokens of a 64 px image; the UNet runs at a narrow width
    "chexpert-unet": (chexpert_unet, dict(encoder_type="nn")),
    "chexpert-dit": (chexpert_dit, dict(encoder_type="DiT", patch_size=4)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ood_torch_main_on_cpu(tmp_path, monkeypatch, capsys, family):
    module, extra = FAMILIES[family]
    monkeypatch.setattr(chexpert_unet, "build_backbone", narrow_chexpert_unet)
    config = dict(
        data_path=write_mimic_tree(tmp_path / "mimic"), image_size=256, wavelet_transform=True,
        classes=2, mixed_precision="no", batch_size=2, num_workers=0, evaluation_per_stage=[1],
        evaluation_batches=1, project_root=str(tmp_path), experiment_dir="exp", **extra,
    )
    seeded = module.build_engine(ExperimentConfig(**config), device="cpu")
    seeded.init_params()
    seeded.save_checkpoint(0)
    path = os.path.join(REPO, "experiments", family, "ood_torch.py")
    spec = importlib.util.spec_from_file_location(f"{family}_ood_torch", path)
    ood_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ood_torch)
    monkeypatch.setenv("INFERENCE_CONFIG", json.dumps(dict(config, ood_dataset="padchest")))
    metric_output, preds, batches = ood_torch.main(["--dataset", "mimic", "--device", "cpu"])
    # MIMIC's 10 rows: 4 of label 0 (2 of them empty), 4 of label 1, 2 of -1;
    # two batches of 2 (evaluation_batches=1)
    assert len(preds) == 2 and len(metric_output) == 4
    assert all(b["images"].shape == (2, 64, 64, 3) for b in batches)
    assert all(set(p.tolist()) <= {0, 1} for p in preds)
    out = capsys.readouterr().out
    assert "mimic [{'accuracy'" in out and "Dataset length: 8" in out
