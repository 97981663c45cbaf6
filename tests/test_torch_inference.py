"""Port parity for the engine, and the port's inference entry point end to end.

1. The port's ``DiffusionClassifier.classify`` (Haar DWT in front) against
   the JAX engine's, on a tiny DiT with bridged weights and the JAX engine's
   own draws injected: identical predictions.
2. ``experiments/chexpert-dit/inference_torch.py`` in a fresh interpreter on
   the CPU (synthetic data, 32 px, DWT, a checkpoint saved first): metrics
   print, predictions come per batch, and neither jax nor the JAX package
   was imported.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_parity import JaxDraws
from diffusion_classifier_tpu.engine import DiffusionClassifier as JaxEngine
from diffusion_classifier_tpu.models.dit import DiT as JaxDiT
from diffusion_classifier_tpu.models.dit import DiTConfig as JaxDiTConfig
from diffusion_classifier_tpu.utils.config import ExperimentConfig as JaxConfig
from diffusion_classifier_tpu_torch.engine import DiffusionClassifier
from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig
from diffusion_classifier_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = dict(
    data_path="synthetic", image_size=32, image_channels=3, wavelet_transform=True,
    classes=2, encoder_type="DiT", mixed_precision="no", batch_size=8,
    evaluation_per_stage=[4], seed=3,
)
# 32 px → DWT 16x16x12 → patch 2: 64 tokens
TINY = dict(
    num_attention_heads=2, attention_head_dim=32, in_channels=12, out_channels=12,
    num_layers=2, sample_size=16, patch_size=2, num_classes=2, attn_backend="auto",
)


def test_engine_classify_with_dwt_matches_jax_engine():
    x = np.random.default_rng(0).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    jeng = JaxEngine(JaxDiT(JaxDiTConfig(**TINY)), JaxConfig.from_dict(dict(CONFIG)))
    jeng.init_params({"images": x})
    jeng._build_train_state(total_steps=1)
    _, classify_key = jax.random.split(jeng._rng)  # the key classify() will take
    want = np.asarray(jeng.classify(x))

    eng = DiffusionClassifier(
        DiT(DiTConfig(**TINY)), ExperimentConfig.from_dict(dict(CONFIG)), device="cpu"
    )
    eng.init_params()
    ema = jax.tree.map(np.asarray, jeng.state.ema_params)
    # classify runs on the EMA copy, as the JAX engine's does
    eng.state.ema_model.load_state_dict(flax_to_state_dict(ema, eng.denoiser))
    got = eng.classify(x, draws=JaxDraws(classify_key, fast=False))
    np.testing.assert_array_equal(got.numpy(), want)


def test_synthetic_val_set_is_the_jax_experiments():
    from diffusion_classifier_tpu.data.synthetic import SyntheticDataLoader
    from diffusion_classifier_tpu_torch.experiments.chexpert_dit import build_data

    config = ExperimentConfig.from_dict(dict(CONFIG))
    jax_val = SyntheticDataLoader(
        256, 64, batch_size=8, image_size=32, channels=3, classes=2, seed=3
    ).get_test_loader()
    port_val = build_data(config).get_test_loader()
    assert len(port_val) == len(jax_val) == 8
    for want, got in zip(jax_val, port_val):
        np.testing.assert_array_equal(got["images"], want["images"])
        np.testing.assert_array_equal(got["prompt"], want["prompt"])


def test_metrics_match_jax():
    from diffusion_classifier_tpu.utils import metrics as jm
    from diffusion_classifier_tpu_torch.utils import metrics as tm

    rng = np.random.default_rng(4)
    names = ("Accuracy", "F1", "Precision", "Recall")
    port = [getattr(tm, n)(n.lower()) for n in names]
    ref = [getattr(jm, n)(n.lower()) for n in names]
    for _ in range(3):
        preds = rng.integers(0, 2, 16)
        batch = {"prompt": rng.integers(0, 2, 16).astype(np.int32)}
        for p, r in zip(port, ref):
            p.update((torch.from_numpy(preds), batch))
            r.update((preds, batch))
    for p, r in zip(port, ref):
        p.sync_across_processes()
        assert p.get_output() == pytest.approx(r.get_output())


def test_engine_refuses_what_is_not_ported():
    eng = DiffusionClassifier(
        DiT(DiTConfig(**TINY)), ExperimentConfig.from_dict(dict(CONFIG)), device="cpu"
    )
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.sample()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.train_loop([], [], plot_function=print)
    with pytest.raises(RuntimeError, match="initialize"):
        eng.classify(np.zeros((1, 32, 32, 3), np.float32))
    with pytest.raises(RuntimeError, match="initialize"):
        eng.loss(np.zeros((1, 32, 32, 3), np.float32))
    bf16_state = DiffusionClassifier(
        DiT(DiTConfig(**TINY)),
        ExperimentConfig.from_dict(dict(CONFIG, optimizer_state_dtype="bf16")),
        device="cpu",
    )
    bf16_state.init_params()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bf16_state._build_train_state(total_steps=1)


_SCRIPT = """
import json, os, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, os.path.join({repo!r}, "experiments", "chexpert-dit"))
import torch
torch.set_num_threads(1)
from diffusion_classifier_tpu_torch.experiments.chexpert_dit import build_engine
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig
import inference_torch

config = ExperimentConfig.from_env("INFERENCE_CONFIG")
seeded = build_engine(config, device="cpu")
seeded.init_params()
seeded.save_checkpoint(0)
metric_output, samples, batches = inference_torch.main(["--device", "cpu"])
print("RESULT " + json.dumps({{
    "metrics": metric_output,
    "pred_shapes": [list(s.shape) for s in samples],
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "diffusion_classifier_tpu")),
}}))
"""


def test_inference_torch_runs_end_to_end_without_jax(tmp_path):
    config = dict(
        CONFIG, patch_size=4, mixed_precision="bf16", evaluation_per_stage=[2],
        evaluation_batches=1, project_root=str(tmp_path), experiment_dir="exp",
    )
    env = dict(os.environ, INFERENCE_CONFIG=json.dumps(config))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(repo=REPO)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    result = json.loads(line[len("RESULT "):])
    assert result["loaded"] == []
    # evaluation_batches=1 runs stop_idx + 1 = 2 batches of 8
    assert result["pred_shapes"] == [[8], [8]]
    names = [next(iter(d)) for d in result["metrics"]]
    assert names == ["accuracy", "f1", "precision", "recall"]
    assert all(0.0 <= next(iter(d.values())) <= 1.0 for d in result["metrics"])
    assert "accuracy" in proc.stdout and "Checkpoint loaded" in proc.stdout
    assert os.path.isfile(tmp_path / "exp" / "checkpoints" / "ema_params.pt")
