"""Mode ``classify_pruned`` on a narrow DiT with a learned Σ, on the CPU.

The DiT-XL/2 cell's configuration at 8 px (16 tokens), 2 layers of 2
heads × 72, 8 output channels over 4, and 20 classes through a three-stage
pruning tournament: a sound run is correct, the control and the classify
faults are not, and ``work()`` counts the rows the tournament scores.
"""

import copy
import json
import os

import pytest
import torch

from portbench import core
from portbench.faults import FAULTS
from portbench.modes import classify_pruned
from tiny import run

WORKLOAD = "dit_xl2_512.classify_in1k_b1"
STAGES = dict(classes=20, n_stages=3, evaluation_per_stage=[2, 4, 8], n_keep_per_stage=[5, 2, 1])


def _tiny(monkeypatch):
    from diffusion_classifier_tpu_torch.experiments import imagenet_dit
    from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig

    def backbone(config):
        dtype = torch.bfloat16 if config.mixed_precision == "bf16" else torch.float32
        return DiT(DiTConfig(num_attention_heads=2, attention_head_dim=72, in_channels=4, out_channels=8,
                             num_layers=2, sample_size=config.image_size, patch_size=2,
                             num_classes=config.classes, attn_backend=config.attn_backend), dtype)

    monkeypatch.setattr(imagenet_dit, "build_backbone", backbone)
    cell = core.find("workloads", WORKLOAD)
    config = copy.deepcopy(core.find("configs", cell["config"]))
    config["experiment"].update(image_size=8, mixed_precision="no", **STAGES)
    config["model"].update(num_layers=2, num_attention_heads=2)
    cell.update(check_within=2, check_calls=2, pool_batches=3, reference_rows=8, reference_sample=6,
                experiment=dict(cell["experiment"], **STAGES))
    with open(os.path.join(os.path.dirname(core.HERE), "BENCHMARK.json")) as f:
        e2e = core.cell_metrics(json.load(f), WORKLOAD, "end_to_end")
    return cell, config, e2e


def test_sound_run_is_correct_and_the_control_is_not(monkeypatch):
    cell, config, e2e = _tiny(monkeypatch)
    sound = run(cell, config, e2e)
    assert sound["correct"], sound["checks"]
    control = run(cell, config, e2e, control=True)
    assert not control["correct"], control["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS["classify"]))
def test_planted_faults_are_not_correct(monkeypatch, fault):
    cell, config, e2e = _tiny(monkeypatch)
    undo = FAULTS["classify"][fault]()
    try:
        result = run(cell, config, e2e)
    finally:
        undo()
    assert not result["correct"], (fault, result["checks"])


def test_work_counts_the_rows_the_tournament_scores():
    runner = classify_pruned.Runner.__new__(classify_pruned.Runner)
    runner.x = dict(evaluation_per_stage=[2, 16, 64], n_keep_per_stage=[50, 5, 1], classes=1000)
    work = runner.work({"full": 3, "attention_flops": 5, "attention_bytes": 7})
    rows = 2 * 1000 + 14 * 50 + 48 * 5
    assert rows == 2940 and work == {"flops": 3 * rows, "attention_flops": 5 * rows, "attention_bytes": 7 * rows}
