"""Tiny stand-ins for the two configurations, for CPU runs of the whole harness.

:func:`tiny` patches the experiments' backbones narrow (the DiT 128 wide in
2 layers; a four-level UNet 32-32-64-64 with one resnet a level) and returns
the cell, its configuration (whose ``model`` block matches the narrow net)
and the end-to-end metrics it reports, at batch 2-4 and 4 evaluations, in
fp32 unless asked otherwise.
"""

from __future__ import annotations

import copy
import json
import os

import torch

from portbench import core

TINY_UNET = {
    "block_out_channels": [32, 32, 64, 64],
    "down_block_types": ["DownBlock2D", "DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D", "UpBlock2D"],
    "layers_per_block": 1,
    "attention_head_dim": 2,
    "norm_num_groups": 8,
    "norm_eps": 1e-05,
    "cross_attention_dim": 32,
    "encoder_hid_dim": 32,
    "encoder_hid_dim_type": "text_proj",
    "in_channels": 3,
    "out_channels": 3,
}


def _tiny_unet(config):
    from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D, UNetConfig

    m = TINY_UNET
    dtype = torch.bfloat16 if config.mixed_precision == "bf16" else torch.float32
    return UNetCondition2D(UNetConfig(
        sample_size=config.image_size, in_channels=3, out_channels=3, layers_per_block=1,
        block_out_channels=tuple(m["block_out_channels"]), down_block_types=tuple(m["down_block_types"]),
        up_block_types=tuple(m["up_block_types"]), encoder_hid_dim=32, encoder_hid_dim_type="text_proj",
        cross_attention_dim=32, attention_head_dim=2, norm_num_groups=8, attn_backend=config.attn_backend,
    ), dtype=dtype)


def tiny(monkeypatch, workload: str, precision: str = "no", root: str = core.HERE):
    """``(cell, config, end_to_end)`` of ``workload`` shrunk for the CPU."""
    from diffusion_classifier_tpu_torch.experiments import chexpert_dit, cifar10

    monkeypatch.setattr(chexpert_dit, "WIDTH", 128)
    monkeypatch.setattr(chexpert_dit, "NUM_LAYERS", 2)
    monkeypatch.setattr(cifar10, "build_backbone", _tiny_unet)
    cell = core.find("workloads", workload, root)
    config = copy.deepcopy(core.find("configs", cell["config"], root))
    config["experiment"].update(image_size=16, mixed_precision=precision)
    if config["reference"] == "dit":
        config["model"].update(num_attention_heads=2, num_layers=2)
    else:
        config["model"] = dict(TINY_UNET)
    cell.update(batch=min(cell["batch"], 4), check_within=2, check_calls=min(cell.get("check_calls", 1), 2),
                pool_batches=3, reference_rows=8, warmup_calls=1)
    if cell["mode"] == "classify":
        cell["experiment"] = dict(cell.get("experiment", {}), evaluation_per_stage=[4])
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as f:
        bench = json.load(f)
    return cell, config, core.cell_metrics(bench, workload, "end_to_end")


def run(cell, config, end_to_end, seed=2**31 + 17, control=False):
    return core.run_cell(cell, copy.deepcopy(config), seed, 0.2, False, "cpu",
                         end_to_end=end_to_end, per_layer=[], control=control)
