"""Counts of DiT-XL/2 at 512 px: one forward row, and its attention.

A row is one 64 × 64 × 4 latent under one class at one evaluation: 1,024
tokens of patch 2 through 28 blocks 1152 wide. Attention a row is
``4·S²·D·H`` operations a layer (q·kᵀ and P·V) at the model's D = 72, not
the 80 the kernel pads to, and it reads q, k, v and writes o once,
``4·S·H·D`` bf16 values a layer.
"""

from __future__ import annotations

import torch

from ..reference import dit_eps
from . import meta_params, reference_flops


def counts(config: dict) -> dict:
    m, x = config["model"], config["experiment"]
    side, c = x["image_size"], m["in_channels"]
    P = meta_params(dit_eps.param_shapes(m, x["classes"]))
    z = torch.empty((1, side, side, c), device="meta")
    lam = torch.empty((1,), device="meta")
    labels = torch.zeros((1,), dtype=torch.long, device="meta")
    s = (side // m["patch_size"]) ** 2
    hd = m["num_attention_heads"] * m["attention_head_dim"]
    return {
        "full": reference_flops(dit_eps.forward, P, m, z, lam, labels),
        "attention_flops": 4 * s * s * hd * m["num_layers"],
        "attention_bytes": 4 * s * hd * 2 * m["num_layers"],
    }
